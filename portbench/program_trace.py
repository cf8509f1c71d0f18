"""The program's own spans and host-synchronisation counts on the card,
against the device trace, for a cell of ``BENCHMARK.json``:

    python3 -m portbench.program_trace --workload dn40-step-b128 --seed <n> --seconds 20 --windows 3

Set-up is the benchmark's (``harness.Program`` on the seed's weights and
batches, the traffic's followed and warm-up units).  Then, in one process:

* the cost of recording: ``--windows`` pairs of windows of ``--seconds``
  each, the program's recording (``utils/timing.record``) off in one and
  on in the other, the order alternating, each a rate over synchronised
  units;
* a clock marker: after a synchronise, a program span around
  ``torch.cuda._sleep`` under the profiler; the sleep kernel's start less
  the span's start;
* ``--units`` units (default the traffic's ``profile_units``) under
  ``torch.profiler`` (device activity, with the CUDA runtime's host-side
  launch events) with the recording on, read by :func:`analyse`.

The last line of standard output is one JSON object; ``--out`` also writes
it to a file.  The program's recording is read only here: the benchmark's
own runs (``run.py``) do not turn it on.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from typing import Dict, List, Optional

import torch

from portbench.trace import _union

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
            "cudaMemcpyAsync", "cudaMemsetAsync")


def innermost(spans, t: int):
    """Index of the innermost (latest opened) span open at ``t``, or None."""
    best = None
    for i, s in enumerate(spans):
        if s.start_ns <= t <= s.end_ns and (best is None or s.start_ns >= spans[best].start_ns):
            best = i
    return best


def analyse(spans, device: List[tuple], launches: List[int], h0: int, h1: int) -> dict:
    """The program's ``spans`` (``utils/timing.Span``, closed) against the
    device's event intervals ``device`` ``[(start ns, end ns)]`` and the
    host's launch calls' start times ``launches`` (ns), all on one clock,
    over the synchronised window ``[h0, h1]``.

    Idle gaps are the stretches of the window that no device interval
    covers.  ``sync_idle_s``: the gaps that open (their start) while a
    sync span is open on the host, whole, by the innermost sync span's
    site; ``idle_by_span``: every gap by the innermost span open at its
    midpoint; ``self_s``: each span name's duration less its children's;
    ``launches_by_span``: the launch calls by the innermost span open at
    their start; ``host_s``: the units' spans' time, ``sync_s`` the sync
    spans' within them; ``dispatch_us_per_launch``: ``host_s - sync_s``
    over the device's launches."""
    merged = _union(device)
    busy = sum(e - s for s, e in merged)
    edges = [h0] + [x for s, e in merged for x in (s, e)] + [h1]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    syncs = [s for s in spans if s.sync]
    idle_by_span: Dict[str, float] = {}
    sync_idle: Dict[str, float] = {}
    for s, e in gaps:
        i = innermost(spans, (s + e) // 2)
        label = spans[i].name if i is not None else "outside spans"
        idle_by_span[label] = idle_by_span.get(label, 0.0) + (e - s) / 1e9
        j = innermost(syncs, s)
        if j is not None:
            sync_idle[syncs[j].name] = sync_idle.get(syncs[j].name, 0.0) + (e - s) / 1e9
    self_s: Dict[str, float] = {}
    children = [0] * len(spans)
    for s in spans:
        if s.parent is not None:
            children[s.parent] += s.end_ns - s.start_ns
    for s, c in zip(spans, children):
        self_s[s.name] = self_s.get(s.name, 0.0) + (s.end_ns - s.start_ns - c) / 1e9
    launches_by_span: Dict[str, int] = {}
    for t in launches:
        i = innermost(spans, t)
        label = spans[i].name if i is not None else "outside spans"
        launches_by_span[label] = launches_by_span.get(label, 0) + 1
    top = [s for s in spans if s.parent is None and s.unit is not None]
    host = sum(s.end_ns - s.start_ns for s in top)
    in_units = [s for s in syncs if s.unit is not None]
    sync_host = sum(s.end_ns - s.start_ns for s in in_units)
    wall = h1 - h0
    return {"wall_s": wall / 1e9, "busy_s": busy / 1e9, "idle_pct": 100.0 * (1 - busy / wall),
            "sync_idle_s": sync_idle, "sync_idle_pct": 100.0 * sum(sync_idle.values()) * 1e9 / wall,
            "idle_by_span": idle_by_span, "self_s": self_s, "launches_by_span": launches_by_span,
            "host_s": host / 1e9, "sync_s": sync_host / 1e9, "device_launches": len(device),
            "dispatch_us_per_launch": ((host - sync_host) / 1e3 / len(device)) if device else None}


def _events(prof):
    """Device intervals ``[(start, end)]`` by kind, and host launch calls."""
    from torch.autograd import DeviceType

    device, launches, named = [], [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() if hasattr(e, "start_ns") else 1000 * e.start_us()
        if e.device_type() == DeviceType.CUDA:
            device.append((start, start + e.duration_ns()))
            named.append((e.name(), start))
        elif e.name() in LAUNCHES:
            launches.append(start)
    return device, launches, named


class Cell:
    """The benchmark's set-up of a cell, to the end of its warm-up."""

    def __init__(self, name: str, seed: int, device: str = "cuda"):
        from portbench import generate, harness
        from portbench.reference.models import Model

        w = harness.workload(name)
        cfg, self.traffic = harness.load("configs", w["config"]), harness.load("traffic", w["traffic"])
        self.kind, self.cuda = self.traffic["entry"], device.startswith("cuda")
        self.batch_size = cfg["program"]["overrides"]["batch_size"]
        gen = generate.generator(seed, device)
        params, state = generate.make_state(Model(cfg["arch"]), gen, device, torch.float32)
        self.batches = generate.make_batches(cfg["data"], self.batch_size,
                                             self.traffic["distinct_batches"], gen, device,
                                             torch.float32)
        self._tmp = tempfile.TemporaryDirectory(prefix="portbench-")
        self.tr = harness.Program(cfg, device, self._tmp.name, params, state, {}).tr
        self.next = self.traffic["follow_steps"] + self.traffic.get("warmup_steps", 0)
        if self.kind == "step":
            for i in range(self.next):
                self.tr.train_step(self._batch(i), fetch=False)
        else:
            self.tr.rho_test(loader=self.batches[:self.next])
        self.sync()

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def _batch(self, i: int) -> dict:
        return self.batches[i % len(self.batches)]

    def units(self, n: Optional[int] = None, deadline: Optional[float] = None) -> int:
        """``n`` units, or units until ``deadline``, from where the last
        call stopped; synchronised; returns how many ran."""
        picked = []

        def stream():
            while (n is None and (not picked or time.perf_counter() < deadline)) or (
                    n is not None and len(picked) < n):
                picked.append(self.next)
                self.next += 1
                yield self._batch(picked[-1])

        if self.kind == "step":
            for b in stream():
                self.tr.train_step(b, fetch=False)
        else:
            self.tr.rho_test(loader=stream())
        self.sync()
        return len(picked)


def cost(cell: Cell, seconds: float, windows: int) -> List[dict]:
    """Rates over windows with the program's recording off and on."""
    from optwboundeigenval_tpu_torch.utils import timing

    out = []
    for k in range(windows):
        for on in ((False, True) if k % 2 == 0 else (True, False)):
            t0 = time.perf_counter()
            if on:
                with timing.record() as rec:
                    n = cell.units(deadline=t0 + seconds)
                syncs = sum(rec.syncs.values())
            else:
                n, syncs = cell.units(deadline=t0 + seconds), None
            dt = time.perf_counter() - t0
            out.append({"recording": on, "units": n, "seconds": dt,
                        "samples_per_s": n * cell.batch_size / dt, "syncs": syncs})
    return out


def profiled(cell: Cell, units: int) -> dict:
    """A clock marker, then ``units`` units under the profiler with the
    program's recording on, read by :func:`analyse`."""
    from torch.profiler import ProfilerActivity

    from optwboundeigenval_tpu_torch.utils import timing

    torch.cuda._sleep(1000)  # load the kernel before the marker
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        with timing.record() as marker:
            with timing.span("marker"):
                torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        with timing.record() as rec:
            h0 = time.time_ns()
            n = cell.units(units)
            h1 = time.time_ns()
    device, launches, named = _events(prof)
    mark = marker.spans[0]
    sleeps = [s for name, s in named if "spin" in name or "sleep" in name]
    window = [(s, e) for s, e in device if s >= h0]
    out = analyse([s for s in rec.spans if s.end_ns is not None], window,
                  [t for t in launches if h0 <= t <= h1], h0, h1)
    out.update(units=n, syncs={k: v / n for k, v in rec.syncs.items()},
               spans_per_unit=len(rec.spans) / n,
               marker_offset_us=(min(sleeps) - mark.start_ns) / 1e3 if sleeps else None,
               marker_launch_us=(min(launches) - mark.start_ns) / 1e3 if launches else None,
               marker_span_us=(mark.end_ns - mark.start_ns) / 1e3,
               launch_events=len(launches))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python3 -m portbench.program_trace")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=20.0)
    parser.add_argument("--windows", type=int, default=3)
    parser.add_argument("--units", type=int, default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.program_trace: needs a CUDA device", file=sys.stderr)
        return 1
    from optwboundeigenval_tpu_torch.utils import precision

    torch.set_num_threads(1)
    precision.set_tf32(False)
    t0 = time.perf_counter()
    cell = Cell(args.workload, args.seed)
    result = {"workload": args.workload, "seed": args.seed,
              "device": torch.cuda.get_device_name(0), "setup_s": time.perf_counter() - t0,
              "cost": cost(cell, args.seconds, args.windows),
              "profile": profiled(cell, args.units or cell.traffic["profile_units"])}
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
