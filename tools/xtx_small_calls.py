#!/usr/bin/env python3
"""Where ``xtx`` loses its time on short calls: the host or the card.

    python3 tools/xtx_small_calls.py                  # this checkout
    python3 tools/xtx_small_calls.py --root DIR       # another checkout
    python3 tools/xtx_small_calls.py --widths 1,8 --rows 10000000,4096

For each K and row count, on dyadic draws made on the card from a seed,
``xtx_xty`` of the checkout at ``--root`` (say the parent commit,
unpacked by ``git archive``) beside ``torch.matmul(x.T, x)``: ms a call
back to back by CUDA events (the host's time shows where it is the
longer), each call alone (the stream sleeps while the host enqueues
it, as chip_smoke.py's ``alone_ms``), and the host's microseconds a call
(the card not waited for).  Each result is held bitwise against the
plain version first.  One JSON line per shape, with the card's name and
power limit.  Needs an NVIDIA GPU with nvcc.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPS = 200


def _ints(text: str) -> list[int]:
    return [int(v) for v in text.split(",")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose port runs (default: this one)")
    ap.add_argument("--widths", type=_ints, default=[1, 2, 8])
    ap.add_argument("--rows", type=_ints, default=[10_000_000, 4096])
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(HERE))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.xtx import ops
    from repro_torch.kernels.xtx.ref import xtx_xty_ref

    if not torch.cuda.is_available():
        print("xtx_small_calls: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    smi = cs.nvidia_smi()
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    for n in args.rows:
        for k in args.widths:
            x = cs.dyadic(torch, gen, (n, k), dev)
            y = cs.dyadic(torch, gen, (n,), dev)
            for got, want in zip(ops.xtx_xty(x, y), xtx_xty_ref(x, y)):
                cs.bitwise(torch, f"xtx ({n}, {k})", got, want)
            row = {"root": root.name, "rows": n, "k": k}
            for name, fn in (("xtx", lambda: ops.xtx_xty(x, y)),
                             ("matmul", lambda: torch.matmul(x.T, x))):
                row[name] = {"ms": cs.cuda_ms(torch, fn, REPS),
                             "alone_ms": cs.alone_ms(torch, fn, REPS),
                             "host_us": cs.host_call_us(torch, fn, REPS)}
            print(f"[small] {root.name} ({n}, {k}): xtx "
                  + ", ".join(f"{v:.4g}" for v in row["xtx"].values())
                  + "; matmul "
                  + ", ".join(f"{v:.4g}" for v in row["matmul"].values())
                  + " (ms back to back, ms alone, host us)")
            print(json.dumps(dict(row, device=smi)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
