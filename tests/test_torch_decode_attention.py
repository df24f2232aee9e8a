"""The port's paged-decode plain version against the JAX package's
`paged_decode_attention`: the Pallas `_decode_kernel` in interpret mode
and the XLA fallback.

The CUDA kernels themselves run only on the card (`chip_smoke.py` holds
them against this plain version there) and under the CPU shim
(`test_torch_cpu_shim.py`); here the wrappers' launch plan, designs,
counters and layout refusals run through a library that records its
arguments."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeperspeed_tpu.ops.pallas.decode_attention import \
    paged_decode_attention as jax_paged_decode
from deeperspeed_tpu_torch.ops.hopper import decode_attention as da

torch.set_num_threads(2)


def _case(seed, B=4, H=2, D=64, ps=16, NP=4, P=24):
    """Random pools, a page permutation, lengths with 0, a partial page
    and an exact page edge, and trash page 0 past every length."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((P, H, ps, D)).astype(np.float32)
    vp = rng.standard_normal((P, H, ps, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, P))[:B * NP].reshape(B, NP)
    lengths = np.array([37, 0, 32, NP * ps][:B], np.int32)
    live = np.arange(NP)[None] * ps < lengths[:, None]
    table = np.where(live, table, 0).astype(np.int32)
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_reference_matches_jax(backend):
    q, kp, vp, table, lengths = _case(0)
    ref = np.asarray(jax_paged_decode(
        *map(jnp.asarray, (q, kp, vp, table, lengths)), backend=backend))
    out = da.paged_decode_attention_reference(
        *map(torch.from_numpy, (q, kp, vp, table, lengths)))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    assert (out.numpy()[lengths == 0] == 0.0).all()


def test_trash_entries_are_never_read():
    """Pages past a sequence's length do not change its output, whatever
    finite values the trash page holds."""
    q, kp, vp, table, lengths = _case(1)
    args = list(map(torch.from_numpy, (q, kp, vp, table, lengths)))
    out = da.paged_decode_attention(*args)
    args[1] = args[1].clone()
    args[2] = args[2].clone()
    args[1][0] = 1e4          # the trash page
    args[2][0] = -1e4
    out2 = da.paged_decode_attention(*args)
    live = lengths > 0
    torch.testing.assert_close(out[live], out2[live], atol=0, rtol=0)


def test_single_token_sequence_is_its_value_row():
    q, kp, vp, table, _ = _case(2)
    lengths = np.array([1, 1, 1, 1], np.int32)
    out = da.paged_decode_attention(
        *map(torch.from_numpy, (q, kp, vp, table, lengths)))
    np.testing.assert_allclose(out.numpy(), vp[table[:, 0], :, 0, :],
                               atol=1e-6)


def test_backends_and_launch_counter_on_cpu():
    args = list(map(torch.from_numpy, _case(3)))
    before = da.launches
    outs = [da.paged_decode_attention(*args, backend=b)
            for b in (None, "auto", "pallas", "xla")]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    assert da.launches == before
    with pytest.raises(ValueError, match="backend"):
        da.paged_decode_attention(*args, backend="cuda")


def test_shape_checks():
    q, kp, vp, table, lengths = map(torch.from_numpy, _case(4))
    with pytest.raises(ValueError, match="v_pages"):
        da.paged_decode_attention(q, kp, vp[:, :1], table, lengths)
    with pytest.raises(ValueError, match="page_table"):
        da.paged_decode_attention(q, kp, vp, table[:2], lengths)
    with pytest.raises(ValueError, match="lengths"):
        da.paged_decode_attention(q, kp, vp, table, lengths[:2])


# -- the cluster kernel's launch plan, through a library that records its
# arguments (the kernels themselves run under the CPU shim,
# `test_torch_cpu_shim.py`, and on the card) --

def _fake_library(monkeypatch):
    """A library whose decode entry points record their arguments and
    succeed, so the wrappers' plan, checks and counters run on the CPU;
    the module's counters are put back afterwards."""
    calls = []
    lib = types.SimpleNamespace(
        ds_paged_decode=lambda *a: calls.append(("bf16", a)) or 0,
        ds_paged_decode_int8=lambda *a: calls.append(("int8", a)) or 0)
    monkeypatch.setattr(da._build, "load_library", lambda: lib)
    monkeypatch.setattr(da._build, "stream_ptr", lambda t: None)
    for name in ("launches", "launches_int8"):
        monkeypatch.setattr(da, name, getattr(da, name))
    for name in ("launches_by_design", "launches_by_design_int8"):
        monkeypatch.setattr(da, name, dict(getattr(da, name)))
    return calls


def _pools(dtype, D, ps=64, NP=16, B=3, H=2, P=None):
    """Torch tensors of one decode call: q, pools (int8 with bf16 scales
    for dtype int8, else q's dtype), page table, lengths."""
    rng = np.random.default_rng(5)
    P = P or B * NP + 1   # the kernel is not run: any page ids will do
    q_dtype = torch.bfloat16 if dtype == torch.int8 else dtype
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(
        np.float32)).to(q_dtype)
    kp = torch.zeros((P, H, ps, D), dtype=dtype)
    vp = torch.zeros_like(kp)
    scales = None
    if dtype == torch.int8:
        scales = (torch.ones((P, H, ps), dtype=torch.bfloat16),
                  torch.ones((P, H, ps), dtype=torch.bfloat16))
    table = torch.from_numpy(rng.integers(1, P, (B, NP)).astype(np.int32))
    lengths = torch.from_numpy(np.resize(np.array([0, ps, NP * ps],
                                                  np.int32), B))
    return q, kp, vp, scales, table, lengths


def _launch(q, kp, vp, scales, table, lengths):
    if scales is None:
        return da.paged_decode_cuda(q, kp, vp, table, lengths)
    return da.paged_decode_int8_cuda(q, kp, vp, *scales, table, lengths)


@pytest.mark.parametrize("NP", [1, 2, 3, 7, 8, 9, 12, 16, 64])
def test_cluster_size_from_page_table_width(NP):
    """A grid that fits one wave of the card takes C = min(8, pages a
    row): the table's width decides it."""
    for B, H in ((1, 1), (2, 12), (4, 12)):
        assert da.launch_plan(B, H, NP) == min(8, NP)


@pytest.mark.parametrize("B,H,NP,want", [
    (16, 12, 16, 4), (16, 12, 64, 4), (16, 12, 3, 3), (16, 12, 2, 2),
    (32, 12, 16, 2), (8, 12, 16, 8), (66, 12, 16, 1), (16, 16, 16, 2)])
def test_cluster_halves_until_the_grid_fits_one_wave(B, H, NP, want):
    """C = min(8, pages a row), halved (rounding up) while B·H·C CTAs
    exceed one wave (6 CTAs on each of 132 SMs); lengths play no part."""
    C = da.launch_plan(B, H, NP)
    assert C == want and 1 <= C <= da.MAX_CLUSTER
    assert B * H * C <= da.SMS * da.CTAS_PER_SM or C == 1


@pytest.mark.parametrize("NP,C", [(1, 1), (2, 2), (3, 3), (8, 8), (9, 8),
                                  (12, 8), (16, 8), (16, 4), (17, 8),
                                  (64, 4), (16, 2)])
def test_every_page_dealt_to_exactly_one_rank(NP, C):
    """The kernel's deal (`csrc/paged_decode.cu`: rank r reads page slots
    r, r + C, r + 2C, ...): every page slot belongs to one rank and the
    ranks' counts differ by at most one, for every cluster size the plan
    can give a row of NP pages."""
    assert C <= min(8, NP)
    dealt = [list(range(r, NP, C)) for r in range(C)]
    flat = sorted(p for pages in dealt for p in pages)
    assert flat == list(range(NP))
    counts = [len(pages) for pages in dealt]
    assert max(counts) - min(counts) <= 1 and min(counts) >= 1


@pytest.mark.parametrize("dtype,D,design", [
    (torch.bfloat16, 64, "cluster"), (torch.bfloat16, 128, "cluster"),
    (torch.bfloat16, 256, "single"), (torch.float32, 64, "single"),
    (torch.float32, 128, "single"), (torch.int8, 64, "cluster"),
    (torch.int8, 128, "cluster"), (torch.int8, 256, "single")])
@pytest.mark.parametrize("NP", [3, 16])
def test_wrapper_launches_the_planned_design(dtype, D, design, NP,
                                             monkeypatch):
    """One library call a wrapper call, carrying `launch_plan`'s cluster
    size for the cluster design and 0 for the single-block kernel, and
    counted under that design."""
    calls = _fake_library(monkeypatch)
    da.reset_launches_by_design()
    args = _pools(dtype, D, NP=NP)
    assert da.kernel_design(args[0], args[1]) == design
    out = _launch(*args)
    assert out.shape == args[0].shape and out.dtype == args[0].dtype
    (entry, a), = calls
    B, H = args[0].shape[:2]
    want = da.launch_plan(B, H, NP) if design == "cluster" else 0
    assert entry == ("int8" if dtype == torch.int8 else "bf16")
    assert a[-3] == want and a[-4] == pytest.approx(D ** -0.5)
    counts = (da.launches_by_design_int8 if dtype == torch.int8
              else da.launches_by_design)
    other = (da.launches_by_design if dtype == torch.int8
             else da.launches_by_design_int8)
    assert counts == {d: int(d == design) for d in da.DESIGNS}
    assert other == dict.fromkeys(da.DESIGNS, 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8])
def test_serving_batch_launches_clusters_of_four(dtype, monkeypatch):
    """GPT-NeoX-125M's decode batch (B=16, H=12, 16 pages a row): 768
    CTAs in clusters of 4."""
    calls = _fake_library(monkeypatch)
    _launch(*_pools(dtype, 64, B=16, H=12, P=20))
    assert calls[0][1][-3] == 4


def test_int8_pools_take_the_cluster_kernel_with_fp32_q(monkeypatch):
    calls = _fake_library(monkeypatch)
    q, kp, vp, scales, table, lengths = _pools(torch.int8, 64)
    out = _launch(q.float(), kp, vp, scales, table, lengths)
    assert out.dtype == torch.float32
    assert calls[0][1][-3] == da.launch_plan(*q.shape[:2], table.shape[1])
    assert calls[0][1][-2] == da._build.DTYPE_CODES[torch.float32]


def _strided_slots(kp):
    """The same pool with the slot and head dims stored the other way
    round: a (page, head) is no longer one contiguous tile."""
    return kp.transpose(1, 2).contiguous().transpose(1, 2)


def _unaligned(t):
    """``t``'s values in a tensor whose data starts 2 elements past a
    16-byte boundary."""
    flat = torch.zeros(t.numel() + 2, dtype=t.dtype)
    out = flat[2:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("case,dtype", [
    ("slot_stride", torch.bfloat16), ("slot_stride", torch.int8),
    ("unaligned_pool", torch.bfloat16), ("unaligned_pool", torch.int8),
    ("unaligned_scales", torch.int8)])
def test_cluster_layout_refusals_never_reach_the_library(case, dtype,
                                                         monkeypatch):
    """A pool the cluster kernel's tile loads cannot read raises before the
    library is called, and nothing is counted."""
    calls = _fake_library(monkeypatch)
    q, kp, vp, scales, table, lengths = _pools(dtype, 64)
    if case == "slot_stride":
        kp, vp = _strided_slots(kp), _strided_slots(vp)
        msg = "slot stride"
    elif case == "unaligned_pool":
        kp, vp = _unaligned(kp), _unaligned(vp)
        msg = "16-byte"
    else:
        scales = tuple(_unaligned(s) for s in scales)
        msg = "16-byte"
    before = (dict(da.launches_by_design), dict(da.launches_by_design_int8),
              da.launches, da.launches_int8)
    with pytest.raises(ValueError, match=msg):
        _launch(q, kp, vp, scales, table, lengths)
    assert calls == []
    assert (dict(da.launches_by_design), dict(da.launches_by_design_int8),
            da.launches, da.launches_int8) == before


def test_single_design_takes_what_the_cluster_kernel_refuses(monkeypatch):
    """fp32 pools keep the single-block kernel, which reads any slot
    stride."""
    calls = _fake_library(monkeypatch)
    q, kp, vp, _, table, lengths = _pools(torch.float32, 64)
    da.paged_decode_cuda(q, _strided_slots(kp), _strided_slots(vp), table,
                         lengths)
    assert calls[0][1][-3] == 0
