"""The plain reference of the heterogeneous SoC (``configs/soc-1M.json``).

A cycle model of N SoCs of the paper's §IV-A web-application scenario
(``examples/heterogeneous_soc.py``), vectorised over the SoCs, worked out
from the configuration and each run's DRAM contents alone, never from the
program under test.  Each SoC is

* a CPU that reads DRAM words ``0 .. n_req - 1`` in turn, one outstanding
  read at a time (a request goes out when no read is outstanding and the
  request channel is ready; a reply retires the read), and keeps the
  freshest analog sample: read ``k``'s result is the word plus the sample
  it held in the cycle the reply arrived;
* a DRAM that takes a request when it serves none, answers it ``latency``
  cycles later (its counter set to ``latency`` on the request and counted
  down to 0 once a cycle, then the reply waits for a ready channel), the
  address taken modulo ``n_req``;
* a PWL ramp on a clock ``divider`` times slower: on every cycle that is a
  multiple of ``divider`` it offers ``(t mod period) / period`` where the
  channel is ready and advances ``t``.

Semantics modelled, as the configuration and the engine's traffic file
state them:

* a channel inside a granule is a register of depth 1 (``"register"``:
  the producer may push only into an empty one) or a queue of
  ``capacity`` slots that holds ``capacity - 1`` packets (``"queue"``);
  the consumer sees what the channel held before the cycle, and a packet
  pushed in cycle t is seen in cycle t + 1;
* whole SoCs sit in a granule, so no channel crosses an exchange;
* the run checks its predicate before every epoch of ``k`` cycles, so it
  stops at the first epoch boundary at which every CPU has retired its
  ``n_req`` reads.

Departures from the example, none of which changes an answer:

* the model carries each read's address and the sample it retires with,
  not the word: the word is ``mem[addr] + sample`` in float32 after the
  run (:func:`results`), the one add the CPU makes.  Nothing in the
  protocol depends on the contents, so one run of the model
  (:func:`schedule`) serves every set of contents;
* the DRAM's contents are an input (the example's are ``10 * addr``);
* the run stops at an epoch boundary, not after the example's fixed 120
  cycles, and the ramp's later samples, which no read retires with, are
  not kept.

This file imports nothing of the program: plain PyTorch on any device.
"""
from __future__ import annotations

import torch


def _channel(n: int, depth: int, device) -> dict:
    """A channel of ``n`` SoCs: occupancy and ``depth`` slots of word 0,
    front first."""
    return {"count": torch.zeros((n,), dtype=torch.int64, device=device),
            "buf": torch.zeros((n, depth), dtype=torch.float32, device=device)}


def _commit(ch: dict, pop: torch.Tensor, push: torch.Tensor, word: torch.Tensor) -> None:
    """The channel after a cycle: the front popped, then ``word`` pushed
    behind what stays."""
    buf = torch.where(pop[:, None], torch.roll(ch["buf"], -1, 1), ch["buf"])
    count = ch["count"] - pop.to(torch.int64)
    slot = count.clamp(max=buf.shape[1] - 1)
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf[rows, slot] = torch.where(push, word, buf[rows, slot])
    ch["buf"], ch["count"] = buf, count + push.to(torch.int64)


def schedule(n: int, *, n_req: int, latency: int, period: int, divider: int,
             k: int, capacity: int, intra: str, max_epochs: int,
             device="cpu") -> tuple:
    """The cycle model of ``n`` SoCs: returns ``(addr, sample, stop)``,
    read ``j`` of SoC ``i`` retiring word ``addr[i, j]`` of its DRAM with
    analog sample ``sample[i, j]`` (float32), and the cycle at which the
    run stops.  ``intra`` is ``"register"`` or ``"queue"``."""
    if intra not in ("register", "queue"):
        raise ValueError(f"intra must be 'register' or 'queue', not {intra!r}")
    depth = 1 if intra == "register" else capacity - 1
    i64 = dict(dtype=torch.int64, device=device)
    z = lambda: torch.zeros((n,), **i64)  # noqa: E731
    no = lambda: torch.zeros((n,), dtype=torch.bool, device=device)  # noqa: E731
    rows = torch.arange(n, device=device)
    req, resp, adc = (_channel(n, depth, device) for _ in range(3))
    # the CPU
    pc, n_done, waiting = z(), z(), no()
    acc = torch.zeros((n,), dtype=torch.float32, device=device)
    addr = torch.zeros((n, n_req), **i64)
    sample = torch.zeros((n, n_req), dtype=torch.float32, device=device)
    # the DRAM: the address it serves stands in for the word
    delay, serving, pending = z(), z(), no()
    # the ramp
    t = z()

    cycle = 0
    for _ in range(max_epochs + 1):
        if bool((n_done >= n_req).all()) or cycle // k >= max_epochs:
            return addr, sample, cycle
        for _ in range(k):
            # every channel as it was before the cycle
            req_v, resp_v, adc_v = (c["count"] > 0 for c in (req, resp, adc))
            req_ok, resp_ok, adc_ok = (c["count"] < depth for c in (req, resp, adc))
            # CPU
            acc = torch.where(adc_v, adc["buf"][:, 0], acc)
            issue = ~waiting & (pc < n_req) & req_ok
            retire = waiting & resp_v
            slot = n_done % n_req
            addr[rows, slot] = torch.where(retire, resp["buf"][:, 0].to(torch.int64),
                                           addr[rows, slot])
            sample[rows, slot] = torch.where(retire, acc, sample[rows, slot])
            req_word = pc.to(torch.float32)
            pc = pc + issue.to(torch.int64)
            n_done = n_done + retire.to(torch.int64)
            waiting = (waiting | issue) & ~retire
            # DRAM
            accept = req_v & ~pending
            send = pending & (delay <= 0) & resp_ok
            resp_word = serving.to(torch.float32)
            delay = torch.where(accept, latency, (delay - 1).clamp(min=0))
            serving = torch.where(accept, req["buf"][:, 0].to(torch.int64) % n_req, serving)
            pending = (pending | accept) & ~send
            # the ramp, on its divided clock
            en = cycle % divider == 0
            offer = adc_ok & en
            adc_word = (t % period).to(torch.float32) / float(period)
            t = t + int(en)
            # the channels
            _commit(req, accept, issue, req_word)
            _commit(resp, retire, send, resp_word)
            _commit(adc, adc_v, offer, adc_word)
            cycle += 1
    raise AssertionError("unreachable")


def results(mem: torch.Tensor, addr: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    """Every CPU's results, (n, n_req) float32: the word each read
    retired plus its sample, one float32 add.  ``mem`` (n, n_req) are the
    DRAM contents."""
    return mem.to(torch.float32).gather(1, addr.to(mem.device)) + sample.to(mem.device)


def run(mem: torch.Tensor, **cfg) -> tuple:
    """``(results, stop cycle)`` of SoCs with DRAM contents ``mem`` (n,
    n_req); ``cfg`` as :func:`schedule` takes it, without ``n``."""
    addr, sample, stop = schedule(mem.shape[0], device=mem.device, **cfg)
    return results(mem, addr, sample), stop


def results_bf16(mem: torch.Tensor, addr: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    """The control: the same results with the word, the sample and their
    sum in bfloat16, the precision below the configuration's float32,
    returned as float32."""
    word = mem.to(torch.bfloat16).gather(1, addr.to(mem.device))
    return (word + sample.to(mem.device).to(torch.bfloat16)).to(torch.float32)
