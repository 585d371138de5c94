"""Which kernel records a ``torch.profiler`` trace keeps on a CUDA card, by
the process's age and by ``TEARDOWN_CUPTI``; and whether the process then
exits.

Each trace runs three small kernels (add, mul, sub), each followed by a
synchronize, and lists the kernel records it kept (A add, M mul, S sub;
``-`` none). Each case runs in a process of its own:

* ``age``: CUPTI kept alive between traces (the default): a trace every
  5 s for 60 s;
* ``teardown``: ``TEARDOWN_CUPTI=1``: 8 traces back to back, then 8 with a
  ``torch.cuda.synchronize()`` just before each;
* ``pad``: CUPTI kept alive, a pair of traces every 10 s for 60 s: one as
  above, one with ``PAD_S`` of idle time (after a synchronize) at either
  end of the trace, around the same three kernels; for each kept record,
  its start minus its operator's start on the host, in us (a negative
  shift puts a record before the trace's own start, so the earliest are
  lost first);
* ``exit1`` / ``exit2``: ``TEARDOWN_CUPTI=1``, one or two traces, then the
  process ends: whether it has exited 40 s after it started (the first
  trace alone takes some 10 s to start CUPTI).

Run on a machine with a CUDA card, from the repository root::

    python3 tests/torch_profiler_probe.py

It imports torch only.
"""

import os
import subprocess
import sys
import time

CASES = {"age": {}, "pad": {}, "teardown": {"TEARDOWN_CUPTI": "1"},
         "exit1": {"TEARDOWN_CUPTI": "1"}, "exit2": {"TEARDOWN_CUPTI": "1"}}
EXIT_LIMIT_S = 40
PAD_S = 0.5


def trace(torch, x, pad=0.0, shifts=None):
    """One trace of three kernels: the records it kept, as letters;
    ``pad`` s idle at either end; ``shifts`` (a list) gains each kept
    record's start minus its operator's start on the host, in us."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for op in (x.add_, x.mul_, x.sub_):
            op(1)
            torch.cuda.synchronize()
        time.sleep(pad)
    kept, ops = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.lower()
            # sub_ runs the add kernel with alpha -1
            kept.append(("M" if "mul" in name else "A" if "add" in name
                         else "?", e.time_range.start))
        elif e.name in ("aten::add_", "aten::mul_", "aten::sub_"):
            ops[e.name] = e.time_range.start
    if shifts is not None:
        adds = [t for k, t in kept if k == "A"]
        for k, t in kept:
            op = ("aten::mul_" if k == "M" else "aten::add_"
                  if k == "A" and t == min(adds) and len(adds) == 2
                  else "aten::sub_" if k == "A" and len(adds) == 2
                  else None)
            shifts.append("%s%s" % (k, "%+.0f" % (t - ops[op])
                                    if op in ops else "?"))
    return "".join(k for k, _ in kept) or "-"


def run_case(name):
    import torch

    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    if name == "age":
        t0 = time.time()
        out = []
        for k in range(13):
            time.sleep(max(0.0, t0 + 5 * k - time.time()))
            out.append("%ds:%s" % (round(time.time() - t0), trace(torch, x)))
        print("age (no teardown):", " ".join(out), flush=True)
    elif name == "pad":
        t0 = time.time()
        out = []
        for k in range(7):
            time.sleep(max(0.0, t0 + 10 * k - time.time()))
            s0, s1 = [], []
            plain = trace(torch, x, 0.0, s0)
            padded = trace(torch, x, PAD_S, s1)
            out.append("%ds: %s %s | padded %s %s" % (
                round(time.time() - t0), plain, " ".join(s0), padded,
                " ".join(s1)))
        print("pad (no teardown):", "; ".join(out), flush=True)
    elif name == "teardown":
        plain = [trace(torch, x) for _ in range(8)]
        synced = []
        for _ in range(8):
            torch.cuda.synchronize()
            synced.append(trace(torch, x))
        print("teardown: back to back", " ".join(plain),
              "| a synchronize before each", " ".join(synced), flush=True)
    else:
        kept = [trace(torch, x) for _ in range(int(name[-1]))]
        print("%s: traces %s, now ending" % (name, " ".join(kept)), flush=True)


def main():
    env = {k: v for k, v in os.environ.items() if k != "TEARDOWN_CUPTI"}
    t0 = time.time()
    procs = {name: subprocess.Popen([sys.executable, __file__, name],
                                    env=dict(env, **extra))
             for name, extra in CASES.items()}
    while procs:
        time.sleep(0.5)
        for name, proc in list(procs.items()):
            limit = EXIT_LIMIT_S if name.startswith("exit") else 120
            if proc.poll() is not None:
                print("%s: exited rc %d after %.1f s" % (
                    name, proc.returncode, time.time() - t0), flush=True)
                del procs[name]
            elif time.time() - t0 > limit:
                proc.kill()
                proc.wait()
                print("%s: still running after %d s, killed" % (name, limit),
                      flush=True)
                del procs[name]
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        run_case(sys.argv[1])
    else:
        sys.exit(main())
