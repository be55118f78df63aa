#!/usr/bin/env python3
"""
Time the main path's kernels of two checkouts of the port in turns, on one
NVIDIA GPU:

    python3 kernel_turns.py OLD_CHECKOUT

``OLD_CHECKOUT`` is the root of another checkout of this repository (for
example the parent commit, unpacked with ``git archive`` into a directory
that ``.gitignore`` lists).  The script runs four processes on the card, in
the order old, new, new, old; each imports the port from its own checkout,
builds that checkout's kernels, and times, through the public wrappers that
the main path calls:

K1 ``banded_gather`` (11 channels) and K2 ``banded_scatter`` (2 channels)
on the M5-3layers and the 23.7k-dof RCM plans, f64, random values from a
seed.

Each time is taken two ways by CUDA events: the eager call (200 calls
after 20 warm-up calls) and the device time (200 calls captured in one CUDA
graph and replayed).  Prints one line per process and, last, a JSON object
with every process's numbers and the card's name and power limit.  Exits
nonzero without CUDA or when a process fails.
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def child(root):
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from chip_smoke import cuda_ms, graph_ms  # this checkout's timers

    sys.path.insert(0, root)  # the port of the checkout under test
    from vf_fem_tpu_torch import config  # noqa: E402
    from vf_fem_tpu_torch.fem import banded  # noqa: E402
    from vf_fem_tpu_torch.mesh import load_gmsh  # noqa: E402

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    out = {"root": root}
    for label in ("M5_3layers", "M5_3layers_rcm_h006"):
        mesh = load_gmsh(os.path.join(HERE, "meshes", label + ".msh"))
        nvert = mesh.num_vertices
        hp = banded.plan_banded(mesh.cells, nvert, gc=config.BANDED_GC)
        dp = banded.to_device(hp, dev)
        F = torch.tensor(rng.standard_normal((11, nvert)), device=dev)
        loc = torch.tensor(rng.standard_normal((dp.nv, 2, dp.ncpad)), device=dev)
        for op, fn in (("gather", lambda: banded.banded_gather(dp, F)),
                       ("scatter", lambda: banded.banded_scatter(dp, loc, nvert))):
            out[f"{op} {label}"] = dict(ms=cuda_ms(torch, fn), device_ms=graph_ms(torch, fn))
    torch.cuda.synchronize()
    print(json.dumps(out), flush=True)


def main():
    if sys.argv[1:2] == ["--child"]:
        return child(sys.argv[2])
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    old = os.path.abspath(sys.argv[1])
    if not os.path.isdir(os.path.join(old, "vf_fem_tpu_torch")):
        sys.exit(f"{old}: not a checkout of the port")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = []
    for which, root in (("old", old), ("new", HERE), ("new", HERE), ("old", old)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            sys.exit(f"{which} ({root}) failed:\n{proc.stdout}\n{proc.stderr}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["which"] = which
        runs.append(res)
        print(which + ": " + ", ".join(
            f"{k} call {v['ms']:.6f} device {v['device_ms']:.6f} ms"
            for k, v in res.items() if isinstance(v, dict)), flush=True)
    print(json.dumps({"card": card, "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
