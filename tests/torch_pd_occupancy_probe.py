"""How the persistent PD solve's occupancy (``csrc/pd_persistent.cu``'s
``__launch_bounds__``: the blocks an SM the compiler must fit, which caps
the registers a thread) moves its device time.

Each variant copies ``nsol_tpu_torch/csrc`` to a directory of its own,
puts its expression in place of the kernel's minimum blocks an SM
(``kRec`` is 0 without records, else the image's dimensions), builds the
library there in a process of its own, and prints ptxas's registers and
spills of the kernel's instances and, for each solve (TVL2/ALG2, 50
iterations), the device ms by the kernel's global-timer stamps
(``fused.persistent_phases``), its launch shape, and the wall ms by CUDA
events in turns (sequence, persistent, persistent, sequence; medians of
15), the two routes' x bit for bit. Run on a machine with a CUDA card,
from the repository root (about a minute a variant, most of it the
build)::

    python3 tests/torch_pd_occupancy_probe.py

It imports torch and the port only.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the minimum blocks an SM, as an expression of kRec
VARIANTS = {"one": "1", "source": None, "two": "2",
            "three without records": "kRec == 0 ? 3 : (kRec == 3 ? 1 : 2)"}
#: (label, shape, batch, records)
SOLVES = (("Lena x 1", (256, 256), 1, False),
          ("Lena x 1 records", (256, 256), 1, True),
          ("Lena x 8", (256, 256), 8, False),
          ("Lena x 8 records", (256, 256), 8, True),
          ("64^3", (64, 64, 64), 1, False),
          ("64^3 records", (64, 64, 64), 1, True),
          ("Man 1024^2 x 1", (1024, 1024), 1, False))
_BOUNDS = re.compile(r"__launch_bounds__\(kThreads \* kPdMaxTeams, ([^)]*)\)")

CHILD = r'''
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from nsol_tpu_torch.ops.cuda import build, fused as F
build.CSRC, build.BUILD_DIR = sys.argv[2], sys.argv[3]
build.load()
lines = build.build_info.get("ptxas", "").splitlines()
regs = {}
for i, ln in enumerate(lines):
    if "Compiling entry function" in ln and "pd_persistent_kernel" in ln:
        name = ln.split("'")[1]
        regs[name[name.index("pd_persistent_kernel") + 20:][:24]] = "; ".join(
            l.split(":", 1)[-1].strip() for l in lines[i + 1:i + 4]
            if "spill" in l or "Used" in l)
dev = torch.device("cuda", 0)

def median_ms(fn, reps=15):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))

rows = {}
for label, shape, nb, record in json.loads(sys.argv[4]):
    b = torch.as_tensor(np.random.RandomState(1).rand(*shape)
                        .astype(np.float32), device=dev)
    solve = F.make_fused_pd_denoise_solver(tuple(shape), "TVL2", "ALG2", 50,
                                           record=record)
    alphas = list(np.linspace(0.01, 1.5, nb)) if nb > 1 else 0.03
    seq = lambda: solve.sequence(b, b, alphas, 8.0)
    pers = lambda: solve(b, b, alphas, 8.0)
    got, want = pers(), seq()
    same = torch.equal(got[0], want[0]) if record else torch.equal(got, want)
    phases = F.persistent_phases(pers, dev)
    rows[label] = {
        "device_ms": sum(us for _, us in phases.values()) / 1e3,
        "turns_ms": [median_ms(f) for f in (seq, pers, pers, seq)],
        "shape": F.pd_persistent_shape(len(shape), False, record, (nb,)
                                       + (1,) * (3 - len(shape))
                                       + tuple(shape)),
        "bits_equal": bool(same)}
print(json.dumps({"ptxas": regs, "solves": rows}))
'''


def main():
    src = os.path.join(ROOT, "nsol_tpu_torch", "csrc")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print("card: %s" % card)
    for name, bounds in VARIANTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            csrc = os.path.join(tmp, "csrc")
            shutil.copytree(src, csrc)
            path = os.path.join(csrc, "pd_persistent.cu")
            with open(path) as f:
                text = f.read()
            found = _BOUNDS.search(text)
            if found is None:
                raise SystemExit("pd_persistent.cu: no launch bounds found")
            if bounds is not None:
                text = text[:found.start(1)] + bounds + text[found.end(1):]
            with open(path, "w") as f:
                f.write(text)
            proc = subprocess.run(
                [sys.executable, "-c", CHILD, ROOT, csrc,
                 os.path.join(tmp, "build"), json.dumps(SOLVES)],
                capture_output=True, text=True)
        if proc.returncode != 0:
            print("%s: failed\n%s" % (name, proc.stderr[-3000:]))
            continue
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        print("variant %s (minimum blocks an SM: %s): ptxas %s" % (
            name, bounds or found.group(1), out["ptxas"]))
        for label, row in out["solves"].items():
            print("  %s: device ms %.4f; ms sequence / persistent / "
                  "persistent / sequence %s; shape (blocks an SM, grid, "
                  "the sequence's blocks, threads, record blocks) %s; "
                  "bits equal %s" % (
                      label, row["device_ms"], " / ".join(
                          "%.3f" % t for t in row["turns_ms"]),
                      row["shape"], row["bits_equal"]), flush=True)


if __name__ == "__main__":
    main()
