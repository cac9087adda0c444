"""The op counter (``repro_torch.launch.op_analysis``), the kernels' shape
path and cost, and ``registry.register``, on the CPU.

The reference's ``hlo_analysis`` reads these quantities from compiled HLO
text; the port counts dispatched operations, so its checks are exact
hand counts:

* a 6-layer matmul chain, forward and backward, counts exactly
  3 · 2 · 16 · 64 · 64 · 6 dot flops, on CPU and meta tensors alike (the
  reference's own test allows 35% around that count);
* the collectives' wire convention: all-reduce at twice its payload, the
  others at once, through ``add_collective`` and through the functional
  collectives of a one-rank gloo group;
* every one of the eight registry entries, on meta tensors, returns the
  shapes and dtypes of its plain version's outputs on the same shapes,
  records exactly its ``cost`` and launches nothing (its plain version
  is replaced by one that raises);
* the live-storage peak and ``repeat``'s scaling, by hand.
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import trace_execution
from repro_torch.kernels import registry
from repro_torch.kernels.column_stats import ops as cs_ops
from repro_torch.kernels.countmin import ops as cm_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.kmeans_assign import ops as km_ops
from repro_torch.kernels.segment_fold import ops as sf_ops
from repro_torch.kernels.xtx import ops as xtx_ops
from repro_torch.launch.op_analysis import OpCounter, analyze, shape_bytes
from repro_torch.launch.scan_registry import (clear_registry, get_registry,
                                              tag_scope, tagged_scan)


def _launches() -> dict:
    mods = (xtx_ops, km_ops, cm_ops, sf_ops, fa_ops, cs_ops)
    return {f"{m.__name__}.{k}": getattr(m, k) for m in mods
            for k in dir(m) if k.endswith("_launches")}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_six_layer_matmul_counts_exact_dot_flops(device):
    x = torch.ones((16, 64), device=device, requires_grad=True)
    w = torch.ones((6, 64, 64), device=device, requires_grad=True)
    clear_registry()
    with OpCounter() as c:
        def body(h, wi):
            return torch.tanh(h @ wi), None
        out, _ = tagged_scan("tagscan_layers_fwd", body, x, w, length=6)
        out.sum().backward()
    res = analyze(c, get_registry())
    # each layer: one forward product, its dx and its dw
    assert res["dot_flops"] == 3 * 2 * 16 * 64 * 64 * 6
    assert res["registry"] == {"tagscan_layers_fwd_L6": 6}
    assert res["kernel_flops"] == 0 and res["total_wire_bytes"] == 0
    clear_registry()


def test_dot_flops_of_each_product_kind():
    a, b = torch.ones((3, 5)), torch.ones((5, 7))
    ba, bb = torch.ones((2, 3, 5)), torch.ones((2, 5, 7))
    x, w = torch.ones((2, 3, 9, 9)), torch.ones((4, 3, 3, 3))
    with OpCounter() as c:
        torch.mm(a, b)
        torch.addmm(torch.ones(7), a, b)
        torch.bmm(ba, bb)
        torch.baddbmm(torch.ones((2, 3, 7)), ba, bb)
        torch.nn.functional.conv2d(x, w)
        torch.add(a, a)
    want = (2 * 3 * 5 * 7 * 2 + 2 * 2 * 3 * 5 * 7 * 2
            + 2 * (2 * 7 * 7) * 4 * 3 * 9)
    assert analyze(c, {})["dot_flops"] == want


def test_conv_backward_flops_are_twice_the_forward():
    x = torch.ones((2, 3, 9, 9), requires_grad=True)
    w = torch.ones((4, 3, 3, 3), requires_grad=True)
    with OpCounter() as c:
        torch.nn.functional.conv2d(x, w).sum().backward()
    fwd = 2 * (2 * 7 * 7) * 4 * 3 * 9
    assert analyze(c, {})["dot_flops"] == 3 * fwd


def test_collective_wire_convention_by_hand():
    c = OpCounter()
    c.add_collective("all-reduce", 100.0)
    c.add_collective("all-gather", 40.0)
    c.add_collective("reduce-scatter", 40.0)
    c.add_collective("all-to-all", 8.0)
    c.add_collective("collective-permute", 4.0)
    with c.repeat(3):
        c.add_collective("all-reduce", 10.0)
    res = analyze(c, {})
    assert res["collective_raw_bytes"] == {
        "all-reduce": 130.0, "all-gather": 40.0, "reduce-scatter": 40.0,
        "all-to-all": 8.0, "collective-permute": 4.0}
    assert res["collective_wire_bytes"]["all-reduce"] == 260.0
    assert res["total_wire_bytes"] == 260.0 + 40 + 40 + 8 + 4
    assert res["collective_counts"]["all-reduce"] == 4
    with pytest.raises(ValueError, match="is not one of"):
        c.add_collective("broadcast", 1.0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_functional_collectives_are_counted_as_dispatched():
    import torch.distributed._functional_collectives as fc
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        x = torch.ones((8, 4))       # 128 bytes
        with OpCounter() as c:
            (fc.all_reduce(x, "sum", dist.group.WORLD) + 0).sum()
            (fc.all_gather_tensor(x, 0, dist.group.WORLD) + 0).sum()
            (fc.reduce_scatter_tensor(x, "sum", 0, dist.group.WORLD)
             + 0).sum()
        res = analyze(c, {})
    finally:
        dist.destroy_process_group()
    assert res["collective_raw_bytes"] == {
        "all-reduce": 128.0, "all-gather": 128.0, "reduce-scatter": 128.0}
    assert res["collective_wire_bytes"] == {
        "all-reduce": 256.0, "all-gather": 128.0, "reduce-scatter": 128.0}


def test_peak_of_live_storage_by_hand():
    with OpCounter() as c:
        a = torch.empty((1000,), device="meta")          # 4000
        b = a + 1                                        # 8000 live
        del a
        v = b.view(10, 100)                              # a view: no new
        b.add_(1)                                        # in place
        d = torch.empty((500,), dtype=torch.float64, device="meta")
        del b, v, d
        e = torch.empty((10,), device="meta")
    assert c.peak == 4000 + 4000
    assert c.live == 40
    del e
    assert c.live == 0


def test_cpu_storage_is_not_tracked_and_views_move_no_bytes():
    x = torch.ones((4, 4))
    with OpCounter() as c:
        x.t()
        x.reshape(16)
        y = x * 2
    res = analyze(c, {})
    assert c.peak == 0 and res["bytes_accessed"] == 2 * 64
    assert y.shape == (4, 4)


def test_repeat_scales_counts_and_scopes_attribute_them():
    a, b = torch.ones((3, 5), device="meta"), torch.ones((5, 7),
                                                          device="meta")
    clear_registry()
    with OpCounter() as c:
        torch.mm(a, b)
        with tag_scope("tagscan_outer", 4), c.repeat(4):
            torch.mm(a, b)
    res = analyze(c, get_registry())
    one = 2 * 3 * 5 * 7
    assert res["dot_flops"] == 5 * one
    assert res["by_scope"][""]["dot_flops"] == one
    assert res["by_scope"]["tagscan_outer_L4"]["dot_flops"] == 4 * one
    assert res["registry"] == {"tagscan_outer_L4": 4}
    clear_registry()


def test_shape_bytes():
    assert shape_bytes((32, 64), torch.float32) == 32 * 64 * 4
    assert shape_bytes((7, 2), torch.bfloat16) == 28
    assert shape_bytes((), torch.int32) == 4


# ---------------------------------------------------------------------------
# Every registry entry on meta: the kernel's shapes and its cost, nothing
# launched, no plain version
# ---------------------------------------------------------------------------

def _args(name, dev):
    f32 = dict(dtype=torch.float32, device=dev)
    n, k, nb = 64, 5, 4
    x, y = torch.ones((n, k), **f32), torch.ones((n,), **f32)
    valid = torch.ones((n,), dtype=torch.bool, device=dev)
    bgids = torch.arange(nb, dtype=torch.int32, device=dev)
    items = torch.arange(n, dtype=torch.int32, device=dev)
    q = torch.ones((2, 4, 33, 16), **f32)
    kv = torch.ones((2, 2, 33, 16), **f32)
    lse = torch.ones((2, 4, 33), **f32)
    return {
        "xtx": ((x, y), {}),
        "kmeans_assign": ((x, torch.ones((3, k), **f32),
                           torch.ones((n,), **f32)), {}),
        "segment_linregr": ((x, y, valid, bgids), {"num_groups": 3}),
        "countmin": ((items, valid, 4, 128), {}),
        "segment_countmin": ((items, valid, bgids),
                             {"depth": 4, "width": 128, "num_groups": 3}),
        "segment_fm": ((items, valid, bgids),
                       {"num_hashes": 8, "bits": 32, "num_groups": 3}),
        "flash_attention": ((q, kv, kv), {"causal": True}),
        "flash_attention_bwd": ((q, kv, kv, q, q, lse), {"causal": True}),
        "column_stats": ((x, valid), {}),
    }[name]


def _meta_of(out):
    if isinstance(out, dict):
        return {k: _meta_of(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return [_meta_of(v) for v in out]
    return (tuple(out.shape), out.dtype)


@pytest.mark.parametrize("name", registry.available())
def test_meta_dispatch_returns_kernel_shapes_and_records_cost(name,
                                                              monkeypatch):
    entry = registry.get(name)
    want = _meta_of(entry.ref(*_args(name, "cpu")[0],
                              **_args(name, "cpu")[1]))
    if name == "kmeans_assign":
        # the kernel's assign is int32 where the plain version's is int64
        want[0] = (want[0][0], torch.int32)
    args, kwargs = _args(name, "meta")

    def no_plain(*a, **k):
        raise AssertionError("a meta tensor reached the plain version")

    monkeypatch.setitem(registry._REGISTRY, name, registry.KernelEntry(
        name, no_plain, entry.cuda, entry.cost))
    before = _launches()
    with trace_execution() as tr, OpCounter() as c:
        out = registry.dispatch(name, *args, **kwargs)
    assert _launches() == before
    assert _meta_of(out) == want
    assert all(t.is_meta for t in torch.utils._pytree.tree_leaves(out))
    flops, nbytes = entry.cost(*args, **kwargs)
    assert analyze(c, {})["kernels"] == {
        name: {"calls": 1.0, "flops": flops, "bytes": nbytes}}
    assert [(e.engine, e.detail["name"]) for e in tr.kernels] == [
        ("meta", name)]
    with pytest.raises(ValueError, match="never the plain version"):
        registry.dispatch(name, *args, impl="ref", **kwargs)


def test_cost_formulas_by_hand():
    assert xtx_ops.xtx_cost(10, 4) == (10 * 4 * 7, 4.0 * (10 * 5 + 4 * 5))
    assert km_ops.assign_cost(10, 3, 2) == (120.0, 4.0 * 30 + 120 + 48)
    assert cm_ops.countmin_cost(10, 4, 8) == (0.0, 50.0 + 128)
    assert sf_ops.linregr_cost(8, 2, 2, 3, rows=5) == (
        5.0 * (3 * 4 + 2), 4.0 * 8 * 3 + 8 + 8 + 4.0 * 3 * (2 * 3 + 3))
    assert sf_ops.sketch_cost(8, 2, 12) == (0.0, 40.0 + 8 + 48)
    # attention at B = 1, Hq = 2, Hk = 1, S = 3, D = 4: 6 causal pairs
    assert fa_ops.forward_cost(1, 2, 1, 3, 4, True, 2) == (
        4.0 * 2 * 4 * 6, 2 * (2.0 * 2 * 3 * 4 + 2.0 * 1 * 3 * 4))
    assert fa_ops.backward_cost(1, 2, 1, 3, 4, False, 4) == (
        2.5 * 4 * 2 * 4 * 9, 4 * (4.0 * 2 * 3 * 4 + 4.0 * 1 * 3 * 4))


def test_meta_flash_through_autograd_records_forward_and_backward():
    q = torch.ones((2, 3, 40, 16), dtype=torch.bfloat16, device="meta",
                   requires_grad=True)
    k = torch.ones((2, 3, 40, 16), dtype=torch.bfloat16, device="meta",
                   requires_grad=True)
    before = _launches()
    with OpCounter() as c:
        out = registry.dispatch("flash_attention", q, k, k, causal=True)
        out.float().sum().backward()
    assert _launches() == before
    assert q.grad.shape == q.shape and q.grad.is_meta
    kernels = analyze(c, {})["kernels"]
    fwd = fa_ops.forward_cost(2, 3, 3, 40, 16, True, 2)
    bwd = fa_ops.backward_cost(2, 3, 3, 40, 16, True, 2)
    assert kernels == {
        "flash_attention": {"calls": 1.0, "flops": fwd[0], "bytes": fwd[1]},
        "flash_attention_bwd": {"calls": 1.0, "flops": bwd[0],
                                "bytes": bwd[1]}}
    # the backward allocates its gradients and the tensor-core scratch
    assert c.peak > 0


# ---------------------------------------------------------------------------
# registry.register
# ---------------------------------------------------------------------------

def test_registry_unknown_kernel_and_duplicate():
    """The reference's use (``tests/test_kernels.py``): an unknown name, a
    bad impl and a duplicate raise; an explicit overwrite is allowed."""
    with pytest.raises(KeyError):
        registry.get("no_such_kernel")
    x = torch.ones((4, 2))
    with pytest.raises(ValueError):
        registry.dispatch("xtx", x, x[:, 0], impl="bogus")
    with pytest.raises(ValueError, match="already registered"):
        registry.register("xtx", ref=lambda: None)
    orig = registry.get("xtx")
    try:
        registry.register("xtx", ref=orig.ref, cuda=orig.cuda,
                          cost=orig.cost, overwrite=True)
        assert registry.get("xtx").ref is orig.ref
    finally:
        registry._REGISTRY["xtx"] = orig


def test_segment_linregr_cost_counts_the_valid_rows_the_bound_counts():
    """Where the validity has values the registry's cost counts the valid
    rows, as chip_smoke.py's bound does; on meta, all rows.  Reading them
    under a counter is not counted as the step's work."""
    x, y = torch.ones((8, 2)), torch.ones(8)
    valid = torch.tensor([1, 1, 0, 1, 1, 0, 1, 0], dtype=torch.bool)
    bgids = torch.arange(2, dtype=torch.int32)
    want = sf_ops.linregr_cost(8, 2, 2, 3, rows=5)
    assert sf_ops.segment_linregr_cost(x, y, valid, bgids,
                                       num_groups=3) == want
    assert sf_ops.segment_linregr_cost(
        x.to("meta"), y.to("meta"), valid.to("meta"), bgids.to("meta"),
        num_groups=3) == sf_ops.linregr_cost(8, 2, 2, 3)
    xs, ys, vs, bs = (t.to("meta") for t in (x, y, valid, bgids))
    with OpCounter() as c:
        registry.dispatch("segment_linregr", xs, ys, vs, bs, num_groups=3)
    assert analyze(c, {})["kernels"]["segment_linregr"]["flops"] == \
        sf_ops.linregr_cost(8, 2, 2, 3)[0]


def test_a_cost_that_reads_its_data_is_not_counted_as_work(monkeypatch):
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
    xm = torch.empty((4, 3), device="meta")
    seen = []

    def cost(x):
        seen.append(x.sum(0).shape)       # an aten op, run with no counter
        return 1.0, 2.0

    registry.register("reads", ref=lambda x: x, cuda=lambda x: x,
                      cost=cost)
    with OpCounter() as c:
        registry.dispatch("reads", xm)
    res = analyze(c, {})
    assert seen == [(3,)]
    # only the recorded cost: the sum in it went uncounted
    assert (res["dot_flops"], res["bytes_accessed"]) == (1.0, 2.0)


def test_register_refuses_supports():
    with pytest.raises(ValueError, match="port rule 4"):
        registry.register("scaled_sum", ref=lambda x: x,
                          supports=lambda x: True)
    assert "scaled_sum" not in registry.available()


def test_registered_kernel_dispatches_traces_and_takes_the_meta_path(
        monkeypatch):
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))
    calls = []

    def ref(x, *, scale):
        calls.append("ref")
        return x.sum(0) * scale

    def cuda(x, *, scale):
        # a kernel's wrapper takes meta tensors itself: the shape path
        calls.append(x.device.type)
        assert x.is_meta, "only the meta call reaches cuda on the CPU"
        return x.new_empty(x.shape[1:])

    def cost(x, *, scale):
        return 2.0 * x.numel(), 4.0 * (x.numel() + x.shape[1])

    entry = registry.register("scaled_sum", ref=ref, cuda=cuda, cost=cost)
    assert registry.get("scaled_sum") is entry
    assert "scaled_sum" in registry.available()
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    with trace_execution() as tr, OpCounter() as c:
        got = registry.dispatch("scaled_sum", x, scale=2.0)
        xm = torch.empty((4, 3), device="meta")
        gm = registry.dispatch("scaled_sum", xm, scale=2.0)
    np.testing.assert_array_equal(got.numpy(), x.sum(0).numpy() * 2)
    assert gm.is_meta and gm.shape == (3,)
    assert calls == ["ref", "meta"]
    assert [e.engine for e in tr.kernels] == ["ref", "meta"]
    # only the meta call (a kernel or its shape path) records the cost
    assert analyze(c, {})["kernels"] == {
        "scaled_sum": {"calls": 1.0, "flops": 24.0, "bytes": 60.0}}
    with pytest.raises(ValueError, match="runs only on the card"):
        registry.dispatch("scaled_sum", x, scale=2.0, impl="cuda")
    # without a cuda wrapper there is no shape path: a meta call raises
    registry.register("plain_only", ref=ref, cost=cost)
    with pytest.raises(ValueError, match="has no meta implementation"):
        registry.dispatch("plain_only", xm, scale=2.0)
    assert calls == ["ref", "meta"]
