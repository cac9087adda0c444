"""A configuration's table, made on the device from the seed.

Rows come in chunks, each from a generator of its own seeded from
``(seed, "base", chunk)``, so any chunk can be made again alone: the
program's table is filled chunk by chunk, and the reference makes the
same rows again, chunk by chunk, once the program's state is freed.

Each column of the configuration's ``columns`` names its ``generator``,
a file ``columns/<generator>.py`` found by that name, with
``make(data, name, spec, gen, n, made)``: the column's ``n`` rows of a
chunk, drawn from ``gen`` after the columns before it (``made``, in the
configuration's order).  A generator that needs draws of its own made
once per seed (a coefficient vector) takes them from
``data.param_gen(name)``.

Nothing here imports the program.
"""

from __future__ import annotations

import hashlib
import importlib.util
import sys
from pathlib import Path
from typing import Iterator

import torch

COLUMNS = Path(__file__).resolve().parents[1] / "columns"


def stream_seed(seed: int, stream: str, index: int) -> int:
    """A 63-bit generator seed for chunk ``index`` of ``stream``."""
    h = hashlib.blake2b(f"{seed}/{stream}/{index}".encode(),
                        digest_size=8).digest()
    return int.from_bytes(h, "little") & ((1 << 63) - 1)


def column_generator(name: str):
    """``columns/<name>.py``, as a module."""
    path = COLUMNS / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no column generator named {name!r} "
                                f"({path})")
    mod_name = f"bench_columns_{name}".replace("-", "_").replace(".", "_")
    mod = sys.modules.get(mod_name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return mod


class Data:
    """The rows of one configuration at one seed, on ``device``.
    ``rows`` overrides the configuration's row count (tests only)."""

    def __init__(self, config: dict, seed: int, device,
                 rows: int | None = None):
        self.config = config
        self.seed = int(seed)
        self.device = torch.device(device)
        self.rows = int(rows if rows is not None else config["rows"])
        self.chunk = int(config["data"]["chunk_rows"])
        self.columns = config["columns"]
        self.generators = {name: column_generator(spec["generator"])
                           for name, spec in self.columns.items()}
        self.params: dict = {}      # a generator's draws made once a seed

    def gen(self, stream: str, index: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(stream_seed(self.seed, stream, index))
        return gen

    def param_gen(self, name: str) -> torch.Generator:
        """The generator of column ``name``'s draws made once a seed."""
        return self.gen(f"param/{name}", 0)

    def block(self, stream: str, index: int, n: int) -> dict:
        """``n`` rows of chunk ``index`` of ``stream``."""
        gen = self.gen(stream, index)
        out: dict = {}
        for name, spec in self.columns.items():
            out[name] = self.generators[name].make(self, name, spec, gen, n,
                                                   out)
        return out

    def base_blocks(self) -> Iterator[dict]:
        """The table's rows as made at the start, chunk by chunk."""
        for c, start in enumerate(range(0, self.rows, self.chunk)):
            yield self.block("base", c, min(self.chunk, self.rows - start))

    def columns_on_device(self) -> dict:
        """The whole table: each column allocated once and filled chunk by
        chunk."""
        cols = None
        start = 0
        for blk in self.base_blocks():
            if cols is None:
                cols = {k: torch.empty((self.rows,) + tuple(v.shape[1:]),
                                       dtype=v.dtype, device=self.device)
                        for k, v in blk.items()}
            n = next(iter(blk.values())).shape[0]
            for k, v in blk.items():
                cols[k][start:start + n].copy_(v)
            start += n
            del blk
        return cols
