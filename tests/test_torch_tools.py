"""The traversal instruments of refraction_tpu_torch (kernels/mtbench.py,
kernels/stallbench.py, and the CLIs mxu_mt_bench.py and stallbench.py)
against the Pallas bodies of tools/mxu_mt_bench.py and tools/stallbench.py,
run on the CPU in interpret mode, on the same numpy inputs.

Tolerances. XLA:CPU contracts a multiply followed by an add into one fused
multiply-add; the ports round the product and the sum apart, as the CUDA
kernels do (built with -fmad=false). So:
- stallbench: tree, extract, loads72 and subplane are bit-equal in
  interpret mode; vecops and while2, chains of ``v * c + x``, are within
  1 ulp. Evaluated op by op (one XLA computation per operation, so
  nothing to contract, and the TPU roll as ``jnp.roll``), all six bodies
  are bit-equal. Each runs on the tool's all-ones carry and on
  `mixed_carry`, whose elements differ, so that the block-wide OR is
  checked.
- _vpu_kernel: interpret mode gives the same winner on every ray and t
  within rtol 1e-3, the tool's own parity bar (contractions inside the
  cross and dot products, amplified where they cancel, moved t by up to
  4.7e-4). Op by op, t and i are bit-equal.
- _mxu_kernel: op by op, with ``jnp.dot`` replaced by the kernel's ordered
  8-term sum, t and i are bit-equal: that pins the epilogue, the packed
  key and its tie rule. In interpret mode only ``jnp.dot``'s own
  summation order differs (op by op with the real ``jnp.dot`` gives the
  same figures): the winner is equal on every ray and t moves by up to
  8.8e-5 relative (V = 64, all-ones cull; 2.6e-5 at V = 70 with the
  +-1 mix), so the bound is rtol 1e-4.
- the tensor-core Woop forms (``woop_visits_tc_plain``, the plain version
  of the ``mma.sync`` kernel, which only a card runs): against the exact
  Woop form and against ``_mxu_kernel`` in interpret mode. 3xTF32 keeps
  the winner on >= 99.9% of rays and t within rtol 5e-4 where the winner
  is equal (measured 1.3e-4 at V = 64, 3.2e-5 at V = 70). One TF32 pass
  rounds both operands to 10 mantissa bits: the winner stays on >= 99% of
  rays (measured 99.7-99.8%), the median relative t error is under 5e-3
  (measured 1.6e-3) and 90% of rays are within 2e-2; where the outputs
  cancel single rays are off by over 10%, which is the instrument's
  finding, not a fault.
"""

import functools
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from refraction_tpu_torch import mxu_mt_bench, stallbench
from refraction_tpu_torch.kernels.mtbench import (
    BIG,
    make_inputs,
    mt_args,
    mt_visits,
    mt_visits_plain,
    woop_args,
    tc_agreement,
    tf32_round,
    woop_visits,
    woop_visits_plain,
    woop_visits_tc,
    woop_visits_tc3,
    woop_visits_tc_plain,
)
from refraction_tpu_torch.kernels.stallbench import (
    VARIANTS,
    stall_form,
    stall_iters,
    mixed_carry,
    stall_iters_plain,
)

# Importing the tools points JAX's compilation cache at the repository's
# committed .jax_cache; put back the tests' own (tests/conftest.py).
_CACHE_DIR = jax.config.jax_compilation_cache_dir
from tools import mxu_mt_bench as tool_mt  # noqa: E402
from tools import stallbench as tool_stall  # noqa: E402

jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)

torch.set_num_threads(1)

_PLANE = (8, 128)
_OUT = [jax.ShapeDtypeStruct(_PLANE, jnp.float32),
        jax.ShapeDtypeStruct(_PLANE, jnp.int32)]


@pytest.fixture(scope="module")
def inputs():
    return make_inputs(0)


def _cull(name):
    if name == "ones":
        return np.ones(_PLANE, np.float32)
    return np.random.default_rng(5).choice(np.float32([-1.0, 1.0]), _PLANE)


def _vpu_interpret(inp, v, cu):
    grid = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=0, grid=(),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)]
        + [pl.BlockSpec(memory_space=pltpu.VMEM)] * 7,
        out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2)
    call = pl.pallas_call(functools.partial(tool_mt._vpu_kernel, V=v),
                          grid_spec=grid, out_shape=_OUT, interpret=True)
    t, i = call(jnp.asarray(inp.tri_flat),
                *(jnp.asarray(x) for x in (*inp.o, *inp.d, cu)))
    return np.asarray(t).reshape(-1), np.asarray(i).reshape(-1)


def _mxu_interpret(inp, v, cu):
    grid = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=0, grid=(),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 3,
        out_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2)
    call = pl.pallas_call(functools.partial(tool_mt._mxu_kernel, V=v),
                          grid_spec=grid, out_shape=_OUT, interpret=True)
    cu_wide = np.broadcast_to(cu.reshape(1, -1), (8, cu.size)).copy()
    t, i = call(jnp.asarray(inp.W), jnp.asarray(inp.rhs),
                jnp.asarray(cu_wide))
    return np.asarray(t).reshape(-1), np.asarray(i).reshape(-1)


def _carry(name):
    return np.ones(_PLANE, np.float32) if name == "ones" else mixed_carry(0)


def _stall_interpret(variant, n_iter, x):
    call = pl.pallas_call(
        functools.partial(tool_stall._kernel, variant=variant,
                          n_iter=n_iter),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(_PLANE, jnp.float32), interpret=True)
    return np.asarray(call(jnp.arange(1024, dtype=jnp.float32),
                           jnp.asarray(x)))


@pytest.fixture
def op_by_op(monkeypatch):
    """Run a Pallas body as plain eager jnp operations: its loops become
    Python loops, so every operation is its own XLA computation; the TPU's
    roll, bitcast and dynamic slice become their jnp and numpy forms."""

    def fori_loop(lo, hi, body, carry):
        for i in range(lo, hi):
            carry = body(jnp.int32(i), carry)
        return carry

    def while_loop(cond, body, carry):
        while bool(cond(carry)):
            carry = body(carry)
        return carry

    monkeypatch.setattr(jax.lax, "fori_loop", fori_loop)
    monkeypatch.setattr(jax.lax, "while_loop", while_loop)
    monkeypatch.setattr(pltpu, "roll",
                        lambda x, shift, axis: jnp.roll(x, shift, axis))
    monkeypatch.setattr(pltpu, "bitcast", jax.lax.bitcast_convert_type)
    monkeypatch.setattr(pl, "ds",
                        lambda start, size: slice(int(start), int(start) + size))


def _stall_plain(variant, n_iter, x):
    return stall_iters_plain(variant, n_iter,
                             torch.arange(1024, dtype=torch.float32),
                             torch.from_numpy(x)).numpy()


def _check_stall_interpret(variant, n_iter, x):
    ref = _stall_interpret(variant, n_iter, x)
    got = _stall_plain(variant, n_iter, x)
    if variant in ("vecops", "while2"):  # XLA:CPU fuses v * c + x
        ulps = np.abs(got - ref) / np.spacing(np.abs(ref))
        assert ulps.max() <= 1.0
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n_iter", [16, 70])
@pytest.mark.parametrize("variant", VARIANTS)
def test_stall_matches_tool_kernel_interpret(variant, n_iter):
    _check_stall_interpret(variant, n_iter, _carry("ones"))


@pytest.mark.parametrize("n_iter", [16, 70])
@pytest.mark.parametrize("variant", VARIANTS)
def test_stall_mixed_carry_matches_tool_kernel_interpret(variant, n_iter):
    _check_stall_interpret(variant, n_iter, _carry("mixed"))


def _check_stall_op_by_op(variant, x):
    out = np.zeros(_PLANE, np.float32)
    tool_stall._kernel(np.arange(1024, dtype=np.float32), x, out,
                       variant=variant, n_iter=70)
    np.testing.assert_array_equal(_stall_plain(variant, 70, x), out)


@pytest.mark.parametrize("variant", VARIANTS)
def test_stall_matches_tool_body_op_by_op(variant, op_by_op):
    _check_stall_op_by_op(variant, _carry("ones"))


@pytest.mark.parametrize("variant", VARIANTS)
def test_stall_mixed_carry_matches_tool_body_op_by_op(variant, op_by_op):
    _check_stall_op_by_op(variant, _carry("mixed"))


def test_mixed_carry_checks_the_whole_block_or():
    """On `mixed_carry` an OR over each warp alone, or the output written
    in reverse, changes what tree, extract and subplane return; on the
    tool's all-ones carry it does not."""
    sm = torch.arange(1024, dtype=torch.float32)

    def warp_or(bits, shifts):
        per_bit = (bits.reshape(32, 32, 1) >> shifts) & 1
        words = (per_bit.amax(dim=1).to(torch.int64)
                 << shifts.to(torch.int64)).sum(-1)
        return words.repeat_interleave(32)

    for name, seen in (("mixed", True), ("ones", False)):
        x = torch.from_numpy(_carry(name))
        whole = {v: stall_iters_plain(v, 70, sm, x)
                 for v in ("tree", "extract", "subplane")}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr("refraction_tpu_torch.kernels.stallbench._or_all",
                       warp_or)
            for v, want in whole.items():
                got = stall_iters_plain(v, 70, sm, x)
                assert (not torch.equal(got, want)) == seen, (name, v)
                assert (not torch.equal(want.flip(0, 1), want)) == seen


@pytest.mark.parametrize("v,cull", [(64, "ones"), (70, "mix")])
def test_mt_matches_tool_vpu_kernel_interpret(inputs, v, cull):
    cu = _cull(cull)
    t_ref, i_ref = _vpu_interpret(inputs, v, cu)
    t, i = mt_visits_plain(*mt_args(inputs, "cpu", cu.reshape(-1)), v)
    assert (t_ref < 1e29).mean() > 0.9
    np.testing.assert_array_equal(i.numpy(), i_ref)
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=1e-3, atol=0)


def test_mt_matches_tool_vpu_body_op_by_op(inputs, op_by_op):
    """V = 70 wraps the 64-sub table; the cull mix tests both signs."""
    cu = _cull("mix")
    out_t = np.zeros(_PLANE, np.float32)
    out_i = np.zeros(_PLANE, np.int32)
    tool_mt._vpu_kernel(inputs.tri_flat, *inputs.o, *inputs.d, cu, out_t,
                        out_i, V=70)
    t, i = mt_visits_plain(*mt_args(inputs, "cpu", cu.reshape(-1)), 70)
    np.testing.assert_array_equal(t.numpy(), out_t.reshape(-1))
    np.testing.assert_array_equal(i.numpy(), out_i.reshape(-1))


@pytest.mark.parametrize("v,cull", [(64, "ones"), (70, "mix")])
def test_woop_matches_tool_mxu_kernel_interpret(inputs, v, cull):
    cu = _cull(cull)
    t_ref, i_ref = _mxu_interpret(inputs, v, cu)
    t, i = woop_visits_plain(*woop_args(inputs, "cpu", cu.reshape(-1)), v)
    t, i = t.numpy(), i.numpy()
    assert (t_ref < 1e29).mean() > 0.9
    assert (i == i_ref).mean() >= 0.999
    np.testing.assert_allclose(t, t_ref, rtol=1e-4, atol=0)


def _ordered_dot(lhs, rhs, preferred_element_type=None):
    """The kernel's product: per output the 8-term sum in k order."""
    out = lhs[:, 0:1] * rhs[0:1]
    for k in range(1, lhs.shape[1]):
        out = out + lhs[:, k:k + 1] * rhs[k:k + 1]
    return out


@pytest.mark.parametrize("v,cull", [(64, "ones"), (70, "mix")])
def test_woop_matches_tool_mxu_body_op_by_op(inputs, v, cull, op_by_op,
                                             monkeypatch):
    """With ``jnp.dot`` summed in the kernel's order, the rest of the body
    (epilogue, packed-key min, update) is bit-equal."""
    monkeypatch.setattr(tool_mt.jnp, "dot", _ordered_dot)
    cu = _cull(cull)
    cu_wide = np.broadcast_to(cu.reshape(1, -1), (8, cu.size)).copy()
    out_t = np.zeros(_PLANE, np.float32)
    out_i = np.zeros(_PLANE, np.int32)
    tool_mt._mxu_kernel(inputs.W, inputs.rhs, cu_wide, out_t, out_i, V=v)
    t, i = woop_visits_plain(*woop_args(inputs, "cpu", cu.reshape(-1)), v)
    np.testing.assert_array_equal(t.numpy(), out_t.reshape(-1))
    np.testing.assert_array_equal(i.numpy(), out_i.reshape(-1))


def test_mt_and_woop_agree_as_the_tool_checks(inputs):
    """The tool's parity check between its two kernels, on the ports."""
    cu = _cull("mix").reshape(-1)
    p = mxu_mt_bench.parity(
        mt_visits_plain(*mt_args(inputs, "cpu", cu), 64),
        woop_visits_plain(*woop_args(inputs, "cpu", cu), 64))
    assert p["hits_mt"] == p["hits_woop"] > 0.9
    assert p["i_match"] >= 0.999 and p["t_match"] == 1.0


def test_make_inputs_equals_the_tools_arrays(inputs, monkeypatch):
    """Capture the arrays tools/mxu_mt_bench.py::main hands its kernels."""
    seen = []

    def fake_pallas_call(kernel, grid_spec, out_shape):
        def call(*args):
            seen.append([np.asarray(a) for a in args])
            return [np.zeros(s.shape, s.dtype) for s in out_shape]
        return call

    monkeypatch.setattr(tool_mt.pl, "pallas_call", fake_pallas_call)
    monkeypatch.setattr(tool_mt.jax, "jit", lambda f: f)
    monkeypatch.setattr(sys, "argv", ["mxu_mt_bench.py", "2", "1"])
    tool_mt.main()
    args_v, args_m = seen[0], seen[1]
    want_v = [inputs.tri_flat, *inputs.o, *inputs.d, inputs.cu]
    for got, want in zip(args_v, want_v, strict=True):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(args_m, [inputs.W, inputs.rhs, inputs.cu_wide],
                         strict=True):
        np.testing.assert_array_equal(got, want)


def test_mxu_mt_bench_cli_on_cpu(capsys):
    wrappers = (mt_visits, woop_visits, woop_visits_tc, woop_visits_tc3)
    before = [k.launches for k in wrappers]
    assert mxu_mt_bench.main(["4", "2", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu (plain versions, host clock)"
    assert re.fullmatch(r"hits mt=(0\.9\d\d) woop=\1 t match=1\.0000 "
                        r"i match=1\.0000", lines[1]), lines[1]
    # One parity line per Woop form: 3xTF32 meets the tool's bar, one TF32
    # pass does not (t to rtol 1e-3 on well under all hits).
    m = re.fullmatch(r"hits mt=(0\.9\d\d) woop_tc=(0\.9\d\d) t match="
                     r"(0\.\d{4}) i match=(\d\.\d{4})", lines[2])
    assert m and float(m[3]) < 0.95 and float(m[4]) >= 0.99, lines[2]
    assert re.fullmatch(r"hits mt=(0\.9\d\d) woop_tc3=\1 t match=1\.0000 "
                        r"i match=1\.0000", lines[3]), lines[3]
    for name, line in zip(("mt", "woop", "woop_tc", "woop_tc3"), lines[4:],
                          strict=True):
        assert re.fullmatch(rf"{name}: slope +-?[\d.]+ ns/visit  \(V=4: "
                            r"[\d.]+ ms, V=16: [\d.]+ ms\)", line), line
    # CPU tensors take the plain versions: no launch is counted.
    assert [k.launches for k in wrappers] == before
    assert mxu_mt_bench.launches_per_kernel(50) == 102


def test_stallbench_cli_on_cpu(capsys):
    assert stallbench.main(["6", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu (plain versions, host clock)"
    assert len(lines) == 1 + len(VARIANTS)
    for variant, line in zip(VARIANTS, lines[1:], strict=True):
        assert re.fullmatch(rf" *{variant}: +[\d.]+ ns/iter", line), line


@pytest.mark.parametrize("tool", [mxu_mt_bench, stallbench],
                         ids=["mxu_mt_bench", "stallbench"])
def test_instrument_clis_cuda_without_cuda_raise(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(["--device", "cuda"])
    assert capsys.readouterr().out == ""


def test_instrument_wrappers_check_their_inputs(inputs):
    tri, o, d, cull = mt_args(inputs, "cpu")
    with pytest.raises(ValueError, match="tri_flat"):
        mt_visits(tri[:-9], o, d, cull, 4)
    with pytest.raises(ValueError, match="cull"):
        mt_visits(tri, o, d, cull[:-1], 4)
    with pytest.raises(ValueError, match="unsupported device"):
        mt_visits(tri.to("meta"), o.to("meta"), d.to("meta"),
                  cull.to("meta"), 4)
    w, rhs, cull = woop_args(inputs, "cpu")
    with pytest.raises(ValueError, match="rhs"):
        woop_visits(w, rhs.t(), cull, 4)
    with pytest.raises(ValueError, match="V"):
        woop_visits(w, rhs, cull, -1)
    sm, x = torch.arange(1024.0), torch.ones(_PLANE)
    with pytest.raises(ValueError, match="variant"):
        stall_iters("roll", 4, sm, x)
    with pytest.raises(ValueError, match="x"):
        stall_iters("tree", 4, sm, x.double())
    # Zero visits: every ray a miss.
    t, i = mt_visits(*mt_args(inputs, "cpu"), 0)
    assert bool((t == np.float32(BIG)).all()) and not bool(i.any())


def test_tf32_round_bit_patterns():
    """Round to nearest on the low 13 mantissa bits, ties away from zero,
    on both signs; exact 0, -0 and 1 and anything already on the grid
    stay; subnormals round on the same grid; the largest finite value
    rounds to infinity."""
    cases = [
        (0x00000000, 0x00000000), (0x80000000, 0x80000000),   # +-0
        (0x3F800000, 0x3F800000), (0xBF800000, 0xBF800000),   # +-1
        (0x3F800FFF, 0x3F800000),   # just under half an ulp: down
        (0x3F801000, 0x3F802000),   # the tie: away from zero
        (0xBF801000, 0xBF802000),   # the tie, negative
        (0x3F801001, 0x3F802000),   # just over: up
        (0x3F803000, 0x3F804000),   # a tie above an odd grid point: up too
        (0x3FFFF000, 0x40000000),   # the carry runs into the exponent
        (0x40490FDB, 0x40490000),   # pi: down
        (0x00000FFF, 0x00000000), (0x00001000, 0x00002000),   # subnormals
        (0x80001800, 0x80002000), (0x007FF000, 0x00800000),
        (0x7F7FFFFF, 0x7F800000), (0x7F7FE000, 0x7F7FE000),   # the top
    ]
    bits = np.array([c[0] for c in cases], np.uint32)
    want = np.array([c[1] for c in cases], np.uint32)
    got = tf32_round(torch.from_numpy(bits.view(np.float32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    # Against the definition in float64 arithmetic, on random values.
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32)
    m, e = np.frexp(x.astype(np.float64))
    m = np.sign(m) * np.floor(np.abs(m) * 2048 + 0.5) / 2048  # 11 bits
    np.testing.assert_array_equal(
        tf32_round(torch.from_numpy(x)).numpy(),
        np.ldexp(m, e).astype(np.float32))
    # hi + lo restores 21 of the 24 mantissa bits.
    xt = torch.from_numpy(x)
    hi = tf32_round(xt)
    lo = tf32_round(xt - hi)
    assert float(((hi + lo - xt).abs() / xt.abs()).max()) < 2.0 ** -21


def _tc_errors(got, ref):
    (t, i), (t_ref, i_ref) = got, ref
    same = np.asarray(i) == np.asarray(i_ref)
    rel = (np.abs(np.asarray(t, np.float64) - np.asarray(t_ref))
           / np.abs(t_ref))[same]
    return float(same.mean()), rel


def _check_tc(passes, got, ref):
    same, rel = _tc_errors(got, ref)
    if passes == 3:
        assert same >= 0.999 and rel.max() <= 5e-4
    else:
        assert same >= 0.99
        assert np.median(rel) < 5e-3 and (rel <= 2e-2).mean() >= 0.9
        assert rel.max() > 1e-3  # one pass is visibly coarser


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("v,cull", [(64, "ones"), (70, "mix")])
def test_woop_tc_plain_against_the_exact_woop(inputs, v, cull, passes):
    args = woop_args(inputs, "cpu", _cull(cull).reshape(-1))
    ref = tuple(x.numpy() for x in woop_visits_plain(*args, v))
    got = tuple(x.numpy() for x in woop_visits_tc_plain(*args, v, passes))
    assert (ref[0] < 1e29).mean() > 0.9
    assert ((got[0] < 1e29) == (ref[0] < 1e29)).all()
    _check_tc(passes, got, ref)


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("v,cull", [(64, "ones"), (70, "mix")])
def test_woop_tc_plain_against_tool_mxu_kernel_interpret(inputs, v, cull,
                                                         passes):
    cu = _cull(cull)
    ref = _mxu_interpret(inputs, v, cu)
    got = woop_visits_tc_plain(*woop_args(inputs, "cpu", cu.reshape(-1)), v,
                               passes)
    _check_tc(passes, tuple(x.numpy() for x in got), ref)


def test_woop_tc_wrappers_on_cpu_and_agreement(inputs):
    """On CPU tensors the two wrappers take the plain version at their
    pass count and count no launch; `tc_agreement` is the bar the card's
    kernel is held to."""
    args = woop_args(inputs, "cpu")
    for fn, passes in ((woop_visits_tc, 1), (woop_visits_tc3, 3)):
        before = fn.launches
        got = fn(*args, 6)
        want = woop_visits_tc_plain(*args, 6, passes)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert fn.launches == before
        agree = tc_agreement(got, want)
        assert agree == {"exact": 1.0, "same_i": 1.0, "t_rel": 0.0,
                         "ok": True}
    exact = woop_visits_plain(*args, 6)
    assert not tc_agreement(woop_visits_tc(*args, 6), exact)["ok"]
    moved = (want[0] * (1 + 5e-4), want[1])
    assert not tc_agreement(moved, want)["ok"]
    with pytest.raises(ValueError, match="passes"):
        woop_visits_tc_plain(*args, 6, 2)
    with pytest.raises(ValueError, match="rhs"):
        woop_visits_tc(args[0], args[1].t(), args[2], 4)
    with pytest.raises(ValueError, match="unsupported device"):
        woop_visits_tc3(*(x.to("meta") for x in args), 4)


def test_mtbench_bound_of_the_tensor_core_forms():
    """The larger of the product over the TF32 rate (two operations per
    multiply-add, counted once for both forms: 3xTF32's extra passes are
    not work of the function) and the FP32 epilogue over the FP32 rate:
    the two pipes run side by side."""
    from refraction_tpu_torch import bounds

    r, v, words = 1024, 512, 3072 * 8
    exact = bounds.mtbench_bound("woop", r, v, words)
    assert exact["ops"] == (48 * 15 + 8 * 13) * r * v
    want_ms = max(8 * 13 * r * v / 67e12, 48 * 8 * 2 * r * v / 495e12) * 1e3
    for kind in ("woop_tc", "woop_tc3"):
        b = bounds.mtbench_bound(kind, r, v, words)
        assert b["bound_by"] == "operations"
        assert b["ops"] == (48 * 8 * 2 + 8 * 13) * r * v
        assert b["bound_ms"] == pytest.approx(want_ms, rel=1e-12)
        assert b["bytes"] == exact["bytes"] and b["bound_ms"] < exact["bound_ms"]
    with pytest.raises(KeyError):
        bounds.mtbench_bound("mxu", r, v, words)


def test_stallbench_bound_note_and_variants_flag(capsys):
    """On CUDA each line ends with the variant's bound at N; the note on a
    fixed clock. --variants times the CUDA block shapes only."""
    assert stallbench.bound_note("vecops", 200_000, 1.98e9) == (
        "(bound 258.6 ns/iter by latency)")
    assert stallbench.bound_note("loads72", 200_000, 1.98e9) == (
        "(bound 145.5 ns/iter by latency)")
    assert stallbench.FORMS == {"1024x1": 1, "256x4": 4}
    sm, x = torch.arange(1024.0), torch.ones(8, 128)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        stall_form(4, "tree", 4, sm, x)
    with pytest.raises(ValueError, match="variant"):
        stall_form(4, "roll", 4, sm, x)
    with pytest.raises(SystemExit):
        stallbench.main(["6", "--device", "cpu", "--variants"])
    assert "--variants" in capsys.readouterr().err
