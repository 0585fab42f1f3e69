"""Quickstart on the PyTorch port — the paper's Listing 1/2 loopback example.

A block receives an SB packet, increments its data word, and retransmits.
The host builds a ``Simulation`` session, sends a packet through a
``TxPort`` queue handle, and receives the result from an ``RxPort`` —
Switchboard's PySbTx/PySbRx workflow (``examples/quickstart.py`` in JAX).

    python examples/torch_quickstart.py                # on the card
    python examples/torch_quickstart.py --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

import torch  # noqa: E402

from repro_torch.core import Block, Network  # noqa: E402
from repro_torch.core.struct import tensor_dataclass  # noqa: E402


@tensor_dataclass
class DutState:
    handshakes: torch.Tensor  # (n,) int32


class IncrementDut(Block):
    """Listing 1: `from_rtl_data = to_rtl_data + 1`, ready/valid passthrough."""

    in_ports = ("to_rtl",)
    out_ports = ("from_rtl",)
    payload_words = 2  # [data, tag]

    def init_state(self, n, params=None, *, generator=None, device=None):
        return DutState(handshakes=torch.zeros((n,), dtype=torch.int32, device=device))

    def step(self, state, rx, tx_ready):
        payload, valid = rx["to_rtl"]
        fire = valid & tx_ready["from_rtl"]
        out = payload.clone()
        out[:, 0] += 1.0
        return (
            state.replace(handshakes=state.handshakes + fire.to(torch.int32)),
            {"to_rtl": fire},                 # pop the input queue on fire
            {"from_rtl": (out, fire)},        # push the incremented packet
        )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs (default cuda; cpu runs the same ops)")
    args = ap.parse_args(argv)

    # "dut = SbDut(); dut.input('testbench.sv'); dut.build()"
    net = Network(payload_words=2, capacity=62)   # paper-standard 62-slot queues
    dut = net.instantiate(IncrementDut(), name="dut")
    net.external_in(dut["to_rtl"], "to_rtl.q")    # tx = PySbTx('to_rtl.q')
    net.external_out(dut["from_rtl"], "from_rtl.q")  # rx = PySbRx('from_rtl.q')

    sim = net.build(device=args.device)  # Simulation session (single-netlist engine)
    sim.reset(0)
    tx = sim.tx("to_rtl.q")        # "tx = PySbTx('to_rtl.q')"
    rx = sim.rx("from_rtl.q")      # "rx = PySbRx('from_rtl.q')"

    # "txp = PySbPacket(data=...); tx.send(txp)"
    ok = tx.send([41.0, 1.0])
    print(f"sent packet (ok={ok}): data=41")

    sim.run(cycles=4)  # let the simulation advance a few cycles

    # "print(rx.recv())"
    payload = rx.recv()
    print(f"received: data={None if payload is None else float(payload[0])}")
    assert payload is not None and float(payload[0]) == 42.0

    # live probe + handshake counters — the PyMonitor side of the paper
    dut_state = sim.probe(dut)
    stats = sim.stats()
    assert int(dut_state.handshakes) == 1
    assert stats["ports"]["tx"]["to_rtl.q"]["sent"] == 1
    assert stats["ports"]["rx"]["from_rtl.q"]["received"] == 1
    print(f"probe: dut fired {int(dut_state.handshakes)}x at cycle "
          f"{stats['cycle']} on {sim.device}")
    print("quickstart OK — the DUT incremented the packet through SPSC queues")
    return stats


if __name__ == "__main__":
    main()
