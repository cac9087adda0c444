#!/usr/bin/env python3
"""Does autograd's grad mode cost a serving forward anything?

    python3 tools/grad_mode_ab.py [--arch xlstm-350m] [--pairs 2]

Draws ``--arch`` at full width and depth in bf16 from a seed (parameters
without a gradient, as ``init_model`` makes them) and times its blocks
(``models.model._run_period`` over every block, the forward without the
embedding and the output projection) on a (2, 4096) input, with grad mode
on and with it off, in A B B A order, ``--pairs`` times.  Nothing requires
a gradient in either, so neither records a graph: the difference is the
host's cost of grad mode on each eager op.  Host clock, synchronized.
Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grad_mode_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.models import model as M

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(20121208)
    model = M.init_model(cfg, generator=gen, device=dev)
    x = torch.randn((2, 4096, cfg.d_model), generator=gen,
                    device=dev).to(model.embed.dtype)
    positions = torch.arange(4096, device=dev)[None].expand(2, 4096)

    def blocks(grad: bool) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.set_grad_enabled(grad):
            M._run_period(cfg, model.blocks, x, positions, None, None, True)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    blocks(False)      # first call: allocator and library warm-up
    times = {True: [], False: []}
    for _ in range(args.pairs):
        for grad in (True, False, False, True):
            times[grad].append(blocks(grad))
    for grad, ts in times.items():
        print(f"[grad_mode] {args.arch} blocks at (2, 4096), grad mode "
              f"{'on' if grad else 'off'}: "
              + ", ".join(f"{t:.3f}" for t in ts) + " s (host clock)")
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
