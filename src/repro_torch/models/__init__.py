"""The LM stack of the port: configs, layers, recurrent blocks, and the
model's init / prefill / decode, as in ``repro.models``."""
