"""The port's measurement kernels on the CPU: the plain versions of the
anchors, the DCCL stages and the grid-window variants against the JAX
package's Pallas kernels in interpret mode, on the same numpy inputs; the
stages' plain versions as pieces of kernel 1's; the wrappers take the plain
versions for CPU tensors and count no launches; the tools refuse to run
without the card.

The JAX tools run as they stand: the anchors with their module globals
``INTERPRET``, ``GRID`` and ``K`` patched, the stage kernels (VMEM block
specs, no ``interpret`` argument) under ``force_tpu_interpret_mode``. Their
outputs are (N, 128) lane rows; slots [:, :81] are the taps k = i*9 + j.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from prior_flow_tpu.geometry import grids as jgrids
from prior_flow_tpu.ops.pallas import dccl_gather as dg
from prior_flow_tpu_torch.ops.kernels import (anchors, dccl_lookup,
                                              dccl_stages, gridwin_variants,
                                              launch_counts,
                                              reset_launch_counts)
from prior_flow_tpu_torch.tools import (coords_occupancy, microbench_gridwin,
                                        microbench_kernel_split,
                                        microbench_vpu_anchor)
from test_torch_port_ops import _centres
from tools import microbench_gridwin as jgw
from tools import microbench_kernel_split as jks
from tools import microbench_vpu_anchor as jva

T = torch.from_numpy
DCCL_ATOL = 5e-5      # the bound tests/test_corr.py uses for DCCL paths
COORDS_ATOL = 1e-5    # px, the Pallas grid window at a 64x128 input
NTAP = 81


def _anchor_inputs(grid):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(grid * jva.TILE_R, jva.LANES)).astype(np.float32)
    idx = np.argsort(rng.random(x.shape), axis=1).astype(np.int32)
    return x, idx


@pytest.mark.parametrize("ilp", [1, 4])
@pytest.mark.parametrize("kind", ["select", "gather", "fma"])
def test_anchor_plain_matches_pallas_interpret(monkeypatch, kind, ilp):
    """Bitwise, all three kinds: XLA fuses the fma step into one rounding,
    as the plain version's ``fma_f32`` rounds it."""
    for name, value in (("INTERPRET", True), ("GRID", 2), ("K", 16)):
        monkeypatch.setattr(jva, name, value)
    x, idx = _anchor_inputs(jva.GRID)
    ref = np.asarray(jva._build(kind, ilp)(jnp.asarray(x), jnp.asarray(idx)))
    got = anchors.anchor_chain(T(x), T(idx), kind, ilp, jva.K)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_step_cost_plain_matches_pallas_interpret(monkeypatch):
    monkeypatch.setattr(jva, "INTERPRET", True)
    x, _ = _anchor_inputs(1)
    x = x[:16 * 8]
    ref = np.asarray(jva._build_step_cost(16)(jnp.asarray(x)))
    np.testing.assert_array_equal(anchors.step_cost_copy(T(x)).numpy(), ref)


def test_fma_plain_rounds_once_unlike_mul_then_add():
    """The plain fma step is y*x + x rounded once: at K = 16 it departs
    from an f32 multiply then add somewhere in 1024 x 128 elements."""
    x, idx = _anchor_inputs(2)
    got = anchors.anchor_chain_plain(T(x), T(idx), "fma", 1, 16).numpy()
    y = x * np.float32(0.5)
    for _ in range(16):
        y = y * x + x
    assert not np.array_equal(got, y)
    np.testing.assert_allclose(got[np.isfinite(got)], y[np.isfinite(got)],
                               rtol=1e-5)


def test_ulps_apart():
    f = lambda *v: torch.tensor(v, dtype=torch.float32)
    inf, nan = float("inf"), float("nan")
    assert microbench_vpu_anchor.ulps_apart(f(1.0, inf, -inf, nan, 0.0),
                                            f(1.0, inf, -inf, nan, -0.0)) == 0
    one_up = torch.nextafter(f(1.0), f(2.0))
    assert microbench_vpu_anchor.ulps_apart(f(1.0), one_up) == 1
    assert microbench_vpu_anchor.ulps_apart(f(-1e-45), f(1e-45)) == 2
    assert microbench_vpu_anchor.ulps_apart(f(nan), f(1.0)) == 2 ** 31


def test_parse_sass_counts_each_chain_kernel():
    text = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_119anchor_chain_kernelILi0ELi4EEEvPK6float4PK4int4PS2_i
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;        /* 0x00000a00ff017b82 */
        /*0010*/                   ISETP.NE.U32.AND P0, PT, R4, RZ, PT ; /* 0x0 */
        /*0020*/                   FSEL R5, R6, R5, P0 ;          /* 0x0 */
        /*0030*/               @P0 FSEL R7, R6, R7, P0 ;          /* 0x0 */
		Function : _ZN12_GLOBAL__N_119anchor_chain_kernelILi2ELi1EEEvPK6float4PK4int4PS2_i
        /*0000*/                   FFMA R5, R5, R6, R6 ;          /* 0x0 */
		Function : _ZN12_GLOBAL__N_121step_cost_copy_kernelEPK6float4PS0_
        /*0000*/                   FFMA R5, R5, R6, R6 ;          /* 0x0 */
"""
    counts = microbench_vpu_anchor.parse_sass(text)
    assert set(counts) == {("select", 4), ("fma", 1)}
    assert counts["select", 4]["FSEL"] == 2
    assert counts["select", 4]["ISETP"] == 1
    assert counts["fma", 1]["FFMA"] == 1
    assert microbench_vpu_anchor.steps_per_element(counts, "select", 4) == 0.5
    assert not microbench_vpu_anchor.chain_intact(counts, "select", 4)
    counts["select", 4]["FSEL"] = 4 * 252
    assert microbench_vpu_anchor.chain_intact(counts, "select", 4)
    counts["select", 4]["FSEL"] -= 1
    assert not microbench_vpu_anchor.chain_intact(counts, "select", 4)


def _plan_indices(rows=40, seed=0):
    """Row permutations but rows 3 and 5: random int32 (any sign,
    duplicates) and a constant; and the rows that are permutations."""
    rng = np.random.default_rng(seed)
    idx = np.argsort(rng.random((rows, 128)), axis=1).astype(np.int32)
    idx[3] = rng.integers(-2 ** 31, 2 ** 31 - 1, 128, dtype=np.int64)
    idx[5] = 77
    perm = [r for r in range(rows) if r not in (3, 5)]
    return T(idx), perm


def test_gather_plan_plain_is_a_conflict_free_coloring():
    """Every lane holds elements of its own lane, each element once; in
    permutation rows every register's 32 sources lie in 32 distinct banks
    (lanes); every source word holds the element the chain gathers."""
    idx, perm = _plan_indices()
    plan = anchors.gather_plan_plain(idx)
    assert plan.shape == (40, 32, 4, 2) and plan.dtype == torch.uint8
    elem, src = plan[..., 0].long(), plan[..., 1].long()
    assert torch.equal(elem % 32, torch.arange(32)[None, :, None].expand_as(
        elem))
    assert torch.equal(elem.reshape(40, 128).sort(1).values,
                       torch.arange(128).expand(40, 128))
    banks = (src % 32).transpose(1, 2)            # (rows, register, lane)
    distinct = torch.tensor([[len(set(b.tolist())) for b in row]
                             for row in banks])
    assert bool((distinct[perm] == 32).all())
    assert int(distinct[3].min()) < 32            # a multigraph of its own
    # the word of element c: lane c % 32 stored its register there
    word_of = torch.empty(40, 128, dtype=torch.long).scatter_(
        1, elem.reshape(40, 128),
        anchors.slot_words().reshape(1, 128).expand(40, 128))
    want = word_of.gather(1, (idx.long() & 127).gather(1, elem.reshape(40,
                                                                       128)))
    assert torch.equal(src.reshape(40, 128), want)


@pytest.mark.parametrize("ilp", [1, 4])
def test_scheduled_gather_chain_is_the_plain_chain(ilp):
    """The chain run on the plan as the kernel runs it is bitwise the
    plain gather chain, permutation rows and others."""
    idx, _ = _plan_indices()
    x = torch.randn(idx.shape, generator=torch.Generator().manual_seed(1))
    plan = anchors.gather_plan_plain(idx)
    got = anchors.gather_chain_scheduled_plain(x, plan, ilp, 16)
    assert torch.equal(got, anchors.anchor_chain_plain(x, idx, "gather", ilp,
                                                       16))


def test_gather_wavefront_model():
    """8 wavefronts per row-step on a permutation's plan (4 stores, 4
    conflict-free loads), about 16 for the old layout's random reads; a
    warp-wide access costs its busiest bank's distinct words."""
    va = microbench_vpu_anchor
    x, idx = va.inputs(torch.device("cpu"), grid=1)
    old, new = va.gather_wavefronts(idx, anchors.gather_plan_plain(idx))
    assert new == 8.0
    assert 14.0 < old < 18.0
    lanes = torch.arange(32)
    assert int(va.access_wavefronts(lanes)) == 1
    assert int(va.access_wavefronts(lanes * 0 + 5)) == 1     # one word
    assert int(va.access_wavefronts(lanes * 32)) == 32       # one bank
    assert int(va.access_wavefronts(lanes % 4 * 32)) == 4



# -- the DCCL stages (kernel 1's pieces) --------------------------------------

def _stage_inputs(rng, lvl, dtype, Q=32, h8=8, w8=16):
    """Q queries of a 64x128 input's level ``lvl`` (1/8 grid h8 x w8)."""
    Hl, Wl = h8 >> lvl, w8 >> lvl
    vA = rng.normal(size=(1, Q, Hl, Wl)).astype(np.float32)
    vB = rng.normal(size=(1, Q, Hl, Wl)).astype(np.float32)
    if dtype == torch.bfloat16:   # bf16-exact values, so both sides agree
        vA, vB = (T(v).to(dtype).float().numpy() for v in (vA, vB))
    cA = _centres(rng, Q, h8, w8).reshape(1, Q, 2)
    cB = _centres(rng, Q, h8, w8).reshape(1, Q, 2)
    return vA, vB, cA, cB


@pytest.mark.parametrize("lvl", [0, 1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_plains_match_pallas_interpret(rng, dtype, lvl):
    """The three stage plain versions against ``_variant_call`` with the
    JAX tool's own-only, gridwin-only and cross-only kernels, at the level
    shapes of a 64x128 input (32 of its queries), two different volumes:
    own and cross at DCCL_ATOL, the coords at COORDS_ATOL (the Pallas
    window adds the integer offsets after taking the centre's fraction,
    ROADMAP Queue 3). The grid window reads no volume, so it is held once
    per level, with the f32 volumes."""
    g = jgrids.rotation_grids(64, 128)
    gA, gB = g.a2b_w2c_8, g.b2a_w2c_8
    Hg, Wg = gA.shape[:2]
    gcatA, gcatB = dg.pack_grid_planes(jnp.asarray(gA)), \
        dg.pack_grid_planes(jnp.asarray(gB))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    vA, vB, cA, cB = _stage_inputs(rng, lvl, dtype)
    _, Q, Hl, Wl = vA.shape
    s = 1.0 / 2 ** lvl
    args = (T(vA).to(dtype), T(vB).to(dtype), T(cA), T(cB), T(gA), T(gB), s)
    pA, _ = dg.pack_volume(jnp.asarray(vA).astype(jdt))
    pB, _ = dg.pack_volume(jnp.asarray(vB).astype(jdt))
    R = pA.shape[1]
    Tt = dg._pick_tile(Q, R, budget=dg.GRID_VMEM_BUDGET, elem_bytes=3)
    stages = [(jks._own_only_kernel, dccl_stages.dccl_own_only, DCCL_ATOL),
              (jks._cross_only_kernel, dccl_stages.dccl_cross_only,
               DCCL_ATOL)]
    if dtype == torch.float32:
        stages.append((jks._gridwin_only_kernel,
                       dccl_stages.dccl_gridwin_only, COORDS_ATOL))
    for kern, plain, atol in stages:
        got = plain(*args)
        with pltpu.force_tpu_interpret_mode():
            ref = jks._variant_call(kern, len(got), pA, pB,
                                    jnp.asarray(cA[0]), jnp.asarray(cB[0]),
                                    gcatA, gcatB, Tt, R, Hl, Wl, Hg, Wg, s)
        for o, r in zip(got, ref):
            assert o.shape == (1, Q, NTAP) and o.dtype == torch.float32
            np.testing.assert_allclose(o[0].numpy(), np.asarray(r)[:, :NTAP],
                                       atol=atol, rtol=0,
                                       err_msg=kern.__name__)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stage_plains_are_kernel_1s_pieces(dtype):
    """The kernel-split tool's gate on the CPU (every wrapper takes its
    plain version): own and cross bitwise kernel 1's plain outputs, the
    grid window bitwise the coords kernel's plain coords, at a 64x128 input,
    every level, and no launch counted."""
    reset_launch_counts()
    for lvl in range(4):
        ins, s = microbench_kernel_split.level_inputs(
            torch.device("cpu"), dtype, lvl, size=(64, 128))
        assert not torch.equal(ins[0], ins[1])
        errs = microbench_kernel_split.gate(ins, s)
        assert errs == {"own_only": 0.0, "gridwin_only": 0.0,
                        "cross_only": 0.0}
    assert not any(launch_counts().values())


def test_stages_swap_roles_as_kernel_1():
    """Branch A's own taps come from volume A and its cross taps from
    volume B: with volume B zero, own_B and cross_A vanish."""
    ins, s = microbench_kernel_split.level_inputs(
        torch.device("cpu"), torch.float32, 1, size=(64, 128))
    vA, vB, cA, cB, gA, gB = ins
    zero = torch.zeros_like(vB)
    own_A, own_B = dccl_stages.dccl_own_only(vA, zero, cA, cB, gA, gB, s)
    cross_A, cross_B = dccl_stages.dccl_cross_only(vA, zero, cA, cB, gA, gB,
                                                   s)
    assert own_A.abs().max() > 0 and cross_B.abs().max() > 0
    assert own_B.abs().max() == 0 and cross_A.abs().max() == 0


# -- the grid-window variants ----------------------------------------------------

def test_gridwin_plains_match_pallas_interpret(rng):
    """The variant plain version against ``variant_call(gridwin_preblend)``
    and the pair's against ``pair_call(gridwin_pair_stacked)`` (B centres
    reversed), both Pallas in interpret mode, at 64x128 and level 1's
    scale, COORDS_ATOL."""
    g = jgrids.rotation_grids(64, 128)
    gA, gB = g.a2b_w2c_8, g.b2a_w2c_8
    Hg, Wg = gA.shape[:2]
    gcatA, gcatB = dg.pack_grid_planes(jnp.asarray(gA)), \
        dg.pack_grid_planes(jnp.asarray(gB))
    cen = _centres(rng, 64, Hg, Wg)
    cenB = cen[::-1].copy()
    for scale in (0.5,):
        ref = jgw.variant_call(jgw.gridwin_preblend, jnp.asarray(cen), gcatA,
                               gcatB, 32, Hg, Wg, scale, interpret=True)
        got = gridwin_variants.gridwin_variant(T(cen), T(gA), T(gB), scale)
        refp = jgw.pair_call(jgw.gridwin_pair_stacked, jnp.asarray(cen),
                             jnp.asarray(cenB), gcatA, gcatB, 32, Hg, Wg,
                             scale, interpret=True)
        gotp = gridwin_variants.gridwin_pair(T(cen), T(cenB), T(gA), T(gB),
                                             scale)
        for o, r in list(zip(got, ref)) + list(zip(gotp, refp)):
            assert o.shape == (64, NTAP)
            np.testing.assert_allclose(o.numpy(), np.asarray(r)[:, :NTAP],
                                       atol=COORDS_ATOL, rtol=0)


def test_gridwin_tool_gate_on_cpu():
    """The gridwin tool's gate with the plain versions (CPU tensors):
    every semantic variant and the pair equal the coords kernel's plain
    coords bitwise, each diagnostic its plain version, and no launch is
    counted; an unknown variant is refused."""
    reset_launch_counts()
    cen_A, cen_B, gA, gB = microbench_gridwin.inputs(torch.device("cpu"),
                                                     size=(64, 128))
    assert not torch.equal(cen_A, cen_B)
    microbench_gridwin.gate(cen_A, cen_B, gA, gB)
    assert not any(launch_counts().values())
    with pytest.raises(ValueError):
        gridwin_variants.gridwin_variant(cen_A, gA, gB, 1.0, "preblend")


def test_gridwin_variant_is_the_lookups_cross_coords(rng):
    """The variants' coords are the ones kernel 1's plain version samples
    its cross taps at: the cross-only stage equals the plain sampler of the
    other volume at the variant's coords."""
    ins, s = microbench_kernel_split.level_inputs(
        torch.device("cpu"), torch.float32, 0, size=(64, 128))
    vA, vB, cA, cB, gA, gB = ins
    cAx, cAy, cBx, cBy = gridwin_variants.gridwin_pair(cA[0], cB[0], gA, gB,
                                                       s)
    cross_A, cross_B = dccl_stages.dccl_cross_only(*ins, s)
    at = lambda x, y: torch.stack([x, y], -1).unsqueeze(0)
    assert torch.equal(cross_A, dccl_lookup.sample_volume_level(vB, at(cAx,
                                                                       cAy)))
    assert torch.equal(cross_B, dccl_lookup.sample_volume_level(vA, at(cBx,
                                                                       cBy)))


def test_gridwin_diagnostic_plains():
    """reads: each tap the unweighted sum of its column's two row pairs,
    against a loop over the centres in numpy. arith: on the probe grid the
    weights of an interior tap sum to 1 and weight x offset interpolates
    the offset, y * Wg + x, at the window coord."""
    rng = np.random.default_rng(3)
    Hg, Wg = 12, 20
    gA = T(rng.normal(size=(Hg, Wg, 2)).astype(np.float32))
    gB = T(rng.normal(size=(Hg, Wg, 2)).astype(np.float32))
    cen = T(rng.uniform([-3, -3], [Wg + 3, Hg + 3], (30, 2)).astype(
        np.float32))
    reads = gridwin_variants.gridwin_reads_plain(cen, gA, gB, 0.5)
    for g, (rx, ry) in ((gA, reads[:2]), (gB, reads[2:])):
        g = g.numpy()
        for n, (cx, cy) in enumerate(cen.numpy()):
            fx, fy = int(np.floor(np.float32(cx * 0.5))), int(np.floor(
                np.float32(cy * 0.5)))
            for i in range(9):
                xa = (fx + i - 4) % Wg
                xb = min(xa + 1, Wg - 1)
                rows = [np.clip(fy + j - 4, 0, Hg - 1) for j in range(10)]
                pair = [g[y, xa] + g[y, xb] for y in rows]
                want = np.array([pair[j] + pair[j + 1] for j in range(9)])
                np.testing.assert_array_equal(rx[n, 9 * i:9 * i + 9].numpy(),
                                              want[:, 0])
                np.testing.assert_array_equal(ry[n, 9 * i:9 * i + 9].numpy(),
                                              want[:, 1])
    inner = T(np.array([[9.3, 5.6], [10.5, 6.25]], np.float32))
    wx, wo, bx, bo = gridwin_variants.gridwin_arith_plain(inner, gA, gB, 1.0)
    assert torch.equal(wx, bx) and torch.equal(wo, bo)
    win = inner.unsqueeze(1) + dccl_lookup.window_delta(4, inner.device)
    np.testing.assert_allclose(wx.numpy(), 1.0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        wo.numpy(), (win[..., 1] * Wg + win[..., 0]).numpy(), rtol=1e-6)



# -- wrappers and tools without the card ----------------------------------------

def test_anchor_wrappers_take_plain_on_cpu_and_check_arguments():
    reset_launch_counts()
    x, idx = microbench_vpu_anchor.inputs(torch.device("cpu"), grid=1)
    assert x.shape == idx.shape == (512, 128) and idx.dtype == torch.int32
    assert torch.equal(idx.sort(dim=1).values.long(),
                       torch.arange(128).expand(512, 128))
    out = anchors.anchor_chain(x, idx, "gather", 4, 8)
    assert torch.equal(out, anchors.anchor_chain_plain(x, idx, "gather", 4, 8))
    assert torch.equal(anchors.gather_plan(idx), anchors.gather_plan_plain(idx))
    assert torch.equal(anchors.step_cost_copy(x), 2 * x)
    assert not any(launch_counts().values())
    for kind, ilp, K in (("shuffle", 1, 16), ("fma", 2, 16), ("fma", 4, 6)):
        with pytest.raises(ValueError):
            anchors.anchor_chain(x, idx, kind, ilp, K)


def test_cold_ms_rotates_inputs_and_outputs_past_the_cache(monkeypatch):
    """The copy's timing calls take consecutive slices of a rotation that
    spans COLD_BYTES of inputs and outputs, and hold every output, so no
    call reuses memory a recent one touched."""
    va = microbench_vpu_anchor
    monkeypatch.setattr(va, "COLD_BYTES", 1 << 20)
    monkeypatch.setattr(va, "queued_ms",
                        lambda fn, n: [fn() for _ in range(n)] and 1.0)
    seen, outs = [], []

    def fn(x):
        seen.append(x.data_ptr())
        outs.append(anchors.step_cost_copy(x))
        return outs[-1]
    assert va.cold_ms(fn, torch.device("cpu"), tiles=16, n=20) == 1.0
    per_call = 2 * 16 * va.TILE_ROWS * va.LANES * 4
    reps = (1 << 20) // per_call
    assert len(set(seen)) == reps and seen[:reps] == seen[reps:2 * reps]
    ptrs = sorted(set(seen))
    assert ptrs[1] - ptrs[0] == per_call // 2
    assert torch.equal(outs[0], outs[reps])


def test_coords_occupancy_variants_change_only_blocks_per_sm():
    """Each variant of the coords kernel's source differs from the source
    in the kBlocksPerSM constant alone, and the source's own count is one
    of the counts the tool times."""
    src = (coords_occupancy._build.CSRC_DIR / "dccl_coords.cu").read_text()
    lines = src.splitlines()
    own = [b for b in coords_occupancy.BLOCKS
           if coords_occupancy.variant_source(b) == src]
    assert len(own) == 1
    for b in coords_occupancy.BLOCKS:
        diff = [(a, v) for a, v in zip(
            lines, coords_occupancy.variant_source(b).splitlines()) if a != v]
        assert diff == ([] if b == own[0] else
                        [(f"constexpr int kBlocksPerSM = {own[0]};",
                          f"constexpr int kBlocksPerSM = {b};")])


@pytest.mark.parametrize("tool", [microbench_vpu_anchor,
                                  microbench_kernel_split,
                                  microbench_gridwin, coords_occupancy])
def test_tools_refuse_to_run_without_the_card(tool):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the tools run there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main()
