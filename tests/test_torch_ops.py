"""paddle_tpu_torch op lowerings against the reference lowerings on
shared numpy inputs (the tests/op_test.py pattern): every op type of the
serving slice's programs, of the WMT Transformer's and GPT-2's training
steps (the modern-decoder options' swish, expand, rotary_embed and
fused_swiglu included), the ops the builders emit before fusion, and the
GPT-2 logits program's main and startup ops; and every ``<op>_grad`` of
the training steps, the port's
``lower_grad_op`` (torch.func.vjp) against the reference's (jax.vjp).
The reference runs its dense (non-Pallas) lowerings on the CPU.

Tolerance: rtol = atol = 1e-5 in float32 (summation order only); index
and copy ops match exactly.  Random init ops cannot match the
reference's threefry streams, so they are held to shape, dtype, range
and moments instead."""

import importlib

import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the reference lowerings)
from paddle_tpu.core.registry import LowerCtx as RefCtx
from paddle_tpu.core.registry import get_op as ref_op
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.core.registry import LowerCtx, get_op
from paddle_tpu_torch.ops import nn_ops

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def fresh_port_state():
    """Fresh port programs, scope and name counters per test."""
    old_main = framework.switch_main_program(framework.Program())
    old_startup = framework.switch_startup_program(framework.Program())
    old_gen = unique_name.switch()
    old_scope = scope_mod._switch_scope(scope_mod.Scope())
    yield
    framework.switch_main_program(old_main)
    framework.switch_startup_program(old_startup)
    unique_name.switch(old_gen)
    scope_mod._switch_scope(old_scope)


def _run_both(op_type, ins, attrs):
    """Run one op through both lowerings on copies of the same numpy
    inputs; returns ({slot: [np]} reference, {slot: [np]} port)."""
    import jax.numpy as jnp

    r = ref_op(op_type).lower(
        RefCtx(), {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        attrs)
    t = get_op(op_type).lower(
        LowerCtx(device="cpu"),
        {s: [torch.tensor(a) for a in v] for s, v in ins.items()}, attrs)
    return ({s: [np.asarray(a) for a in v] for s, v in r.items()},
            {s: [a.numpy() for a in v] for s, v in t.items()})


def _check(op_type, ins, attrs, exact=False):
    ref, out = _run_both(op_type, ins, attrs)
    assert set(out) == set(ref), (op_type, set(out), set(ref))
    for slot in ref:
        for a, b in zip(ref[slot], out[slot]):
            assert a.shape == b.shape, (op_type, slot, a.shape, b.shape)
            if exact:
                np.testing.assert_array_equal(b, a.astype(b.dtype))
            else:
                np.testing.assert_allclose(b, a, **TOL)


_R = np.random.RandomState(5)
_F = lambda *s: _R.randn(*s).astype("float32")  # noqa: E731
_I = lambda hi, *s: _R.randint(0, hi, s).astype("int64")  # noqa: E731

_CASES = {
    "lookup_table": ("lookup_table", {"W": [_F(11, 6)], "Ids": [_I(11, 3, 4)]},
                     {"padding_idx": -1}, True),
    "lookup_table_pad": ("lookup_table",
                         {"W": [_F(11, 6)], "Ids": [_I(11, 3, 4)]},
                         {"padding_idx": 2}, True),
    "reshape2": ("reshape2", {"X": [_F(2, 3, 4)]}, {"shape": [2, 12]}, True),
    "reshape2_zero": ("reshape2", {"X": [_F(2, 3, 4)]}, {"shape": [0, -1]},
                      True),
    "transpose2": ("transpose2", {"X": [_F(2, 3, 4, 5)]},
                   {"axis": [0, 2, 1, 3]}, True),
    "gather": ("gather", {"X": [_F(9, 4)], "Index": [_I(9, 2, 3)]}, {}, True),
    "assign": ("assign", {"X": [_F(3, 4)]}, {}, True),
    "slice": ("slice", {"Input": [_F(8, 4)]},
              {"axes": [0], "starts": [0], "ends": [5]}, True),
    "fill_constant": ("fill_constant", {},
                      {"shape": [2, 3], "dtype": "float32", "value": 0.5},
                      True),
    "mul": ("mul", {"X": [_F(2, 3, 4)], "Y": [_F(4, 5)]},
            {"x_num_col_dims": 2, "y_num_col_dims": 1}, False),
    "matmul_ty": ("matmul", {"X": [_F(2, 3, 4)], "Y": [_F(5, 4)]},
                  {"transpose_X": False, "transpose_Y": True, "alpha": 1.0},
                  False),
    "elementwise_add": ("elementwise_add", {"X": [_F(2, 3, 4)],
                                            "Y": [_F(2, 3, 4)]},
                        {"axis": -1}, False),
    "elementwise_add_axis1": ("elementwise_add", {"X": [_F(2, 3, 4)],
                                                  "Y": [_F(3, 4)]},
                              {"axis": 1}, False),
    "elementwise_mul_axis0": ("elementwise_mul", {"X": [_F(3, 2, 4, 2)],
                                                  "Y": [_F(3)]},
                              {"axis": 0}, False),
    "gelu": ("gelu", {"X": [_F(4, 7)]}, {}, False),
    "layer_norm": ("layer_norm", {"X": [_F(2, 3, 8)], "Scale": [_F(8)],
                                  "Bias": [_F(8)]},
                   {"begin_norm_axis": 2, "epsilon": 1e-5}, False),
    "fused_residual_ln": ("fused_residual_ln",
                          {"X": [_F(2, 3, 8)], "Y": [_F(2, 3, 8)],
                           "Scale": [_F(8)], "Bias": [_F(8)]},
                          {"epsilon": 1e-5, "begin_norm_axis": 2}, False),
    "fused_attention_qvec": (
        "fused_attention",
        {"Q": [_F(3, 2, 4, 8)], "K": [_F(3, 2, 12, 8)], "V": [_F(3, 2, 12, 8)],
         "QStart": [np.array([0, 5, 8], "int64")]},
        {"causal": True, "scale": 8 ** -0.5, "window": 0}, False),
    "fused_attention_qvec_one_row": (
        "fused_attention",
        {"Q": [_F(1, 2, 4, 8)], "K": [_F(1, 2, 12, 8)], "V": [_F(1, 2, 12, 8)],
         "QStart": [np.array([6], "int64")]},
        {"causal": True, "scale": 8 ** -0.5, "window": 0}, False),
    "fused_attention_causal": (
        "fused_attention",
        {"Q": [_F(2, 2, 6, 8)], "K": [_F(2, 2, 6, 8)], "V": [_F(2, 2, 6, 8)]},
        {"causal": True, "scale": None, "window": 0}, False),
    "fused_attention_bias": (
        "fused_attention",
        {"Q": [_F(2, 2, 3, 8)], "K": [_F(2, 2, 6, 8)], "V": [_F(2, 2, 6, 8)],
         "Bias": [np.where(_R.rand(2, 6) < 0.3, -1e9, 0).astype("float32")]},
        {"causal": False, "scale": 0.3, "window": 0}, False),
    "fused_attention_scalar_qstart": (
        "fused_attention",
        {"Q": [_F(2, 2, 3, 8)], "K": [_F(2, 2, 9, 8)], "V": [_F(2, 2, 9, 8)],
         "QStart": [np.array([4], "int64")]},
        {"causal": True, "scale": None, "window": 0}, False),
    "fused_attention_window": (
        "fused_attention",
        {"Q": [_F(2, 2, 6, 8)], "K": [_F(2, 2, 6, 8)], "V": [_F(2, 2, 6, 8)],
         "Bias": [np.where(_R.rand(2, 6) < 0.3, -1e9, 0).astype("float32")]},
        {"causal": True, "scale": None, "window": 2}, False),
    "fused_attention_segments": (
        "fused_attention",
        {"Q": [_F(2, 2, 6, 8)], "K": [_F(2, 2, 6, 8)], "V": [_F(2, 2, 6, 8)],
         "SegmentIds": [np.array([[0, 0, 1, 1, 1, 2], [0, 1, 1, 1, 1, 1]],
                                 "int32")]},
        {"causal": True, "scale": None, "window": 3}, False),
    "fused_attention_scalar_qstart_window": (
        "fused_attention",
        {"Q": [_F(2, 2, 3, 8)], "K": [_F(2, 2, 9, 8)], "V": [_F(2, 2, 9, 8)],
         "QStart": [np.array([4], "int64")]},
        {"causal": True, "scale": None, "window": 2}, False),
}
for _act in ("", "relu", "tanh", "sigmoid", "gelu", "swish"):
    _CASES["fc_" + (_act or "none")] = (
        "fc", {"Input": [_F(2, 3, 6)], "W": [_F(6, 5)], "Bias": [_F(5)]},
        {"in_num_col_dims": 2, "activation_type": _act}, False)
_CASES["fc_nobias"] = ("fc", {"Input": [_F(4, 6)], "W": [_F(6, 5)]},
                       {"in_num_col_dims": 1, "activation_type": "gelu"},
                       False)
_LBL = _I(13, 2, 5, 1)
_LBL[0, 0, 0] = -1  # outside the vocab: the smoothing term only
_CASES.update({
    "scale": ("scale", {"X": [_F(3, 4)]},
              {"scale": 1.5, "bias": -0.5, "bias_after_scale": True}, False),
    "scale_bias_first": ("scale", {"X": [_F(3, 4)]},
                         {"scale": 2.0, "bias": 1.0,
                          "bias_after_scale": False}, False),
    "sum": ("sum", {"X": [_F(3, 4), _F(3, 4), _F(3, 4)]}, {}, False),
    "softmax": ("softmax", {"X": [_F(2, 3, 7)]}, {"axis": -1}, False),
    "relu": ("relu", {"X": [_F(3, 5)]}, {}, True),
    "elementwise_sub": ("elementwise_sub", {"X": [_F(2, 3)], "Y": [_F(2, 3)]},
                        {"axis": -1}, False),
    "elementwise_div": ("elementwise_div", {"X": [_F(2, 3)],
                                            "Y": [_F(2, 3) + 3.0]},
                        {"axis": -1}, False),
    "elementwise_min": ("elementwise_min", {"X": [_F(1)], "Y": [_F(1)]},
                        {"axis": -1}, True),
    "elementwise_pow": ("elementwise_pow",
                        {"X": [np.abs(_F(1)) + 0.5],
                         "Y": [np.array([-0.5], "float32")]},
                        {"axis": -1}, False),
    "reduce_sum_all": ("reduce_sum", {"X": [_F(2, 3, 4)]},
                       {"dim": [0], "keep_dim": False, "reduce_all": True},
                       False),
    "reduce_sum_dim": ("reduce_sum", {"X": [_F(2, 3, 4)]},
                       {"dim": [1, -1], "keep_dim": True, "reduce_all": False},
                       False),
    "unsqueeze2": ("unsqueeze2", {"X": [_F(2, 5)]}, {"axes": [2]}, True),
    "one_hot": ("one_hot", {"X": [_LBL]}, {"depth": 13}, True),
    "increment": ("increment", {"X": [np.array([3.0], "float32")]},
                  {"step": 1.0}, True),
    "fill_zeros_like": ("fill_zeros_like", {"X": [_F(2, 3)]}, {}, True),
    "assign_value": ("assign_value", {},
                     {"shape": [2, 2], "values": [0.5, 1.0, -2.0, 3.0],
                      "np_dtype": "float32"}, True),
    "label_smooth": ("label_smooth",
                     {"X": [np.eye(7, dtype="float32")[[1, 4, 6]]]},
                     {"epsilon": 0.1}, False),
    "softmax_with_cross_entropy_soft": (
        "softmax_with_cross_entropy",
        {"Logits": [_F(2, 5, 13)],
         "Label": [np.full((2, 5, 13), 1 / 13, "float32")]},
        {"soft_label": True, "ignore_index": -100}, False),
    "smooth_label_xent": ("smooth_label_xent",
                          {"Logits": [_F(2, 5, 13)], "Label": [_LBL]},
                          {"epsilon": 0.1}, False),
    "fused_linear_xent": ("fused_linear_xent",
                          {"X": [_F(2, 5, 6)], "W": [_F(6, 13)],
                           "Label": [_LBL]},
                          {"epsilon": 0.1, "transpose_w": False}, False),
    "fused_linear_xent_tied": ("fused_linear_xent",
                               {"X": [_F(2, 5, 6)], "W": [_F(13, 6)],
                                "Label": [_LBL]},
                               {"epsilon": 0.0, "transpose_w": True}, False),
    "clip": ("clip", {"X": [_F(4, 5)]}, {"min": -0.5, "max": 0.7}, False),
    "clip_scalar": ("clip", {"X": [np.array([3.0], "float32")]},
                    {"min": 1e-5, "max": 1e30}, False),
    "layer_norm_axis1": ("layer_norm", {"X": [_F(2, 3, 8)],
                                        "Scale": [_F(24)], "Bias": [_F(24)]},
                         {"begin_norm_axis": 1, "epsilon": 1e-5}, False),
    "layer_norm_no_bias": ("layer_norm", {"X": [_F(2, 3, 8)],
                                          "Scale": [_F(8)]},
                           {"begin_norm_axis": 2, "epsilon": 1e-5}, False),
    "dropout_is_test": ("dropout", {"X": [_F(3, 4)]},
                        {"dropout_prob": 0.3, "is_test": True, "seed": 0,
                         "dropout_implementation": "downgrade_in_infer"},
                        False),
    "dropout_upscale_is_test": ("dropout", {"X": [_F(3, 4)]},
                                {"dropout_prob": 0.3, "is_test": True,
                                 "seed": 0,
                                 "dropout_implementation": "upscale_in_train"},
                                True),
    "dropout_p0": ("dropout", {"X": [_F(3, 4)]},
                   {"dropout_prob": 0.0, "is_test": False, "seed": 0,
                    "dropout_implementation": "downgrade_in_infer"}, True),
    "sgd": ("sgd", {"Param": [_F(3, 4)], "Grad": [_F(3, 4)],
                    "LearningRate": [np.array([0.1], "float32")]}, {}, False),
    "swish": ("swish", {"X": [_F(4, 7) * 3]}, {"beta": 1.0}, False),
    "swish_beta": ("swish", {"X": [_F(4, 7) * 3]}, {"beta": 0.7}, False),
    "expand": ("expand", {"X": [_F(2, 3, 1, 4, 5)]},
               {"expand_times": [1, 1, 3, 1, 1]}, True),
    "expand_every_axis": ("expand", {"X": [_F(2, 3)]},
                          {"expand_times": [2, 3]}, True),
    "rotary_embed": ("rotary_embed", {"X": [_F(2, 3, 5, 8)]},
                     {"base": 10000.0}, False),
    "rotary_embed_pos": ("rotary_embed",
                         {"X": [_F(2, 3, 5, 8)],
                          "Pos": [np.array([3, 9, 17, 30, 31], "int64")]},
                         {"base": 10000.0}, False),
    "rotary_embed_pos_rows": ("rotary_embed",
                              {"X": [_F(2, 3, 4, 8)],
                               "Pos": [np.array([[0, 1, 2, 3],
                                                 [25, 26, 27, 28]], "int64")]},
                              {"base": 500.0}, False),
    "fused_swiglu": ("fused_swiglu",
                     {"X": [_F(2, 3, 6)], "GateW": [_F(6, 5)],
                      "UpW": [_F(6, 5)]}, {"x_num_col_dims": 2}, False),
    "fused_swiglu_2d": ("fused_swiglu",
                        {"X": [_F(7, 6)], "GateW": [_F(6, 9)],
                         "UpW": [_F(6, 9)]}, {"x_num_col_dims": 1}, False),
    "tanh": ("tanh", {"X": [_F(4, 7) * 2]}, {}, False),
    "mean": ("mean", {"X": [_F(3, 4, 5)]}, {}, False),
    "reduce_mean_all": ("reduce_mean", {"X": [_F(2, 3, 4)]},
                        {"dim": [0], "keep_dim": True, "reduce_all": True},
                        False),
    "reduce_mean_dim": ("reduce_mean", {"X": [_F(2, 3, 4)]},
                        {"dim": [-1, 0], "keep_dim": False,
                         "reduce_all": False}, False),
    "squeeze2": ("squeeze2", {"X": [_F(4, 1, 6)]}, {"axes": [1]}, True),
    "squeeze2_negative": ("squeeze2", {"X": [_F(4, 6, 1)]}, {"axes": [-1]},
                          True),
    "squeeze2_every_unit_axis": ("squeeze2", {"X": [_F(1, 4, 1, 6)]},
                                 {"axes": []}, True),
    "squeeze2_two_axes": ("squeeze2", {"X": [_F(1, 4, 1)]}, {"axes": [0, 2]},
                          True),
    # the NSP head's form: the fused_softmax_xent path of both packages
    # (the reference's dense branch on the CPU); labels inside [0, C)
    "softmax_with_cross_entropy_hard_2d": (
        "softmax_with_cross_entropy",
        {"Logits": [_F(6, 5) * 3], "Label": [_I(5, 6, 1)]},
        {"soft_label": False, "ignore_index": -100}, False),
    "softmax_with_cross_entropy_hard_2d_flat_label": (
        "softmax_with_cross_entropy",
        {"Logits": [_F(6, 2) * 3], "Label": [_I(2, 6)]},
        {"soft_label": False, "ignore_index": -100}, False),
    "softmax_with_cross_entropy_ignore_index": (
        "softmax_with_cross_entropy",
        {"Logits": [_F(6, 5)], "Label": [_I(5, 6, 1)]},
        {"soft_label": False, "ignore_index": 2}, False),
    "softmax_with_cross_entropy_hard_3d": (
        "softmax_with_cross_entropy",
        {"Logits": [_F(2, 3, 5)], "Label": [_I(5, 2, 3, 1)]},
        {"soft_label": False, "ignore_index": -100}, False),
    "adam": ("adam", {"Param": [_F(3, 4)], "Grad": [_F(3, 4)],
                      "Moment1": [_F(3, 4) * 0.1],
                      "Moment2": [np.abs(_F(3, 4)) * 0.1],
                      "Beta1Pow": [np.array([0.9 ** 3], "float32")],
                      "Beta2Pow": [np.array([0.997 ** 3], "float32")],
                      "LearningRate": [np.array([1e-3], "float32")]},
             {"beta1": 0.9, "beta2": 0.997, "epsilon": 1e-9}, False),
})


@pytest.mark.parametrize("case", sorted(_CASES))
def test_lowering_matches_reference(case):
    op_type, ins, attrs, exact = _CASES[case]
    _check(op_type, ins, attrs, exact)


@pytest.mark.parametrize("pos,width", [
    ([0, 3, 6], [4, 2, 0]),     # dropped beyond width; a free (width-0) row
    ([5, 6, 7], [4, 4, 4]),     # dropped past t_max = 8
    ([4, 0, 7], [3, 4, 1]),     # ends at t_max exactly; a full row; the last cell
])
def test_slot_cache_write_matches_reference_and_drops(pos, width):
    B, H, W, T, D = 3, 2, 4, 8, 2
    cache = _F(B, H, T, D)
    new = _F(B, H, W, D)
    ins = {"Cache": [cache], "New": [new], "Pos": [np.array(pos, "int64")],
           "Width": [np.array(width, "int64")]}
    ref, out = _run_both("slot_cache_write", ins, {})
    np.testing.assert_array_equal(out["Out"][0], ref["Out"][0])
    # never clamped: every cell outside the valid writes keeps its value
    expect = cache.copy()
    for b in range(B):
        for i in range(min(width[b], T - pos[b])):
            expect[b, :, pos[b] + i] = new[b, :, i]
    np.testing.assert_array_equal(out["Out"][0], expect)


@pytest.mark.parametrize("op_type,attrs", [
    ("gaussian_random", {"shape": [64, 64], "dtype": "float32", "mean": 0.5,
                         "std": 0.02, "seed": 0}),
    ("uniform_random", {"shape": [64, 64], "dtype": "float32", "min": -0.2,
                        "max": 0.3, "seed": 0}),
])
def test_random_init_ops_match_reference_distribution(op_type, attrs):
    ref, out = _run_both(op_type, {}, attrs)
    a, b = ref["Out"][0], out["Out"][0]
    assert a.shape == b.shape and b.dtype == np.float32
    if op_type == "uniform_random":
        lo, hi = attrs["min"], attrs["max"]
        mean, std = (lo + hi) / 2, (hi - lo) / 12 ** 0.5
        assert b.min() >= lo and b.max() < hi
    else:
        mean, std = attrs["mean"], attrs["std"]
    # each package's draw holds the op's own moments to 4 standard errors;
    # the two draws are not compared with each other, since independent
    # draws differ by about one standard error by chance
    n = b.size
    for draw in (a, b):
        assert abs(draw.mean() - mean) < 4 * std / n ** 0.5
        assert abs(draw.std() - std) < 4 * std / (2 * n) ** 0.5
    # seeded: the same run context draws the same numbers
    again = get_op(op_type).lower(LowerCtx(device="cpu"), {}, attrs)
    np.testing.assert_array_equal(again["Out"][0].numpy(), b)


@pytest.mark.parametrize("b,n_qstart,window,kernel", [
    (3, 3, 0, True),   # the ragged step's per-row QStart
    (1, 1, 0, True),   # a one-slot pool: one row, one base
    (3, 1, 0, False),  # one base for three rows: the scalar form (B9)
    (1, 1, 2, False),  # a window needs the scalar form
])
def test_fused_attention_qstart_dispatch(monkeypatch, b, n_qstart, window,
                                         kernel):
    """Which QStart forms reach the flash_attention_qvec wrapper (and so
    its CUDA kernel on the card); the others take flash_attention_piece
    (B9's kernel on the card, whose window form refuses a CUDA
    tensor)."""
    calls = []
    real = nn_ops.flash_attention_qvec

    def spy(*args):
        calls.append(args[3].tolist())
        return real(*args)

    monkeypatch.setattr(nn_ops, "flash_attention_qvec", spy)
    q = torch.tensor(_F(b, 2, 3, 8))
    k = torch.tensor(_F(b, 2, 9, 8))
    qs = torch.arange(4, 4 + n_qstart)
    out = get_op("fused_attention").lower(
        LowerCtx(device="cpu"), {"Q": [q], "K": [k], "V": [k], "QStart": [qs]},
        {"causal": True, "scale": None, "window": window})
    assert out["Out"][0].shape == (b, 2, 3, 8)
    if kernel:
        # one base per (batch row, head) row of the kernel
        assert calls == [np.repeat(qs.numpy(), 2).tolist()]
    else:
        assert calls == []


def test_unported_attention_forms_raise_on_cuda_tensors(monkeypatch):
    """The attention forms with no kernel, as in the reference, raise
    before any launch: a window on the per-row QStart form, a window
    without causal, segment ids beside a query base.  The window and
    segment forms are ported: on the kernel path they launch B3's (or
    B9's) kernels with the window and the int32 ids as operands."""
    from paddle_tpu_torch.kernels import build, flash_attention_piece

    monkeypatch.setattr(build, "use_kernel", lambda t: True)
    launched = []
    monkeypatch.setattr(build, "launch",
                        lambda name, *args: launched.append((name, args)))
    q = torch.ones(2, 2, 4, 64)
    lower = get_op("fused_attention").lower
    with pytest.raises(ValueError, match="per-row QStart"):
        lower(LowerCtx(device="cpu"),
              {"Q": [q], "K": [q], "V": [q], "QStart": [torch.tensor([1, 2])]},
              {"causal": True, "scale": None, "window": 2})
    with pytest.raises(ValueError, match="window requires causal"):
        lower(LowerCtx(device="cpu"), {"Q": [q], "K": [q], "V": [q]},
              {"causal": False, "scale": None, "window": 2})
    qk = torch.ones(2, 4, 64)
    fa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    with pytest.raises(ValueError, match="segment ids require"):
        fa._fwd("flash_attention_fwd", qk, qk, qk, None, True, None,
                torch.tensor([1]), 0, torch.zeros(2, 4, dtype=torch.long))
    assert launched == []
    seg = torch.tensor([[1, 1, 2, 0], [1, 2, 2, 2]])
    for ins, attrs in (
            ({"QStart": [torch.tensor([1])]}, {"window": 2}),
            ({"SegmentIds": [seg]}, {}),
            ({}, {"window": 2}),
            ({"SegmentIds": [seg]}, {"window": 3})):
        lower(LowerCtx(device="cpu"), dict({"Q": [q], "K": [q], "V": [q]},
                                           **ins),
              dict({"causal": True, "scale": None, "window": 0}, **attrs))
    assert [name for name, _ in launched] == ["ptt_flash_attention_fwd"] * 4
    for (_, args), window, with_seg in zip(launched, (2, 0, 2, 3),
                                           (False, True, False, True)):
        assert args[-2] == window
        if with_seg:
            # the [B, T] ids broadcast over the heads, as int32
            assert args[-1].dtype == torch.int32
            assert args[-1].tolist() == seg.repeat_interleave(2, 0).tolist()
        else:
            assert args[-1] is None
    flash_attention_piece(qk, qk, qk, True, None, torch.tensor([1]), 2)
    assert launched[-1][0] == "ptt_flash_attention_fwd"
    assert launched[-1][1][-2] == 2


@pytest.mark.parametrize("ins,attrs,kernel", [
    ({}, {"causal": True}, True),
    ({"Bias": [np.zeros((2, 5), "float32")]}, {"causal": False}, True),
    ({}, {"causal": False}, True),
    ({"SegmentIds": [np.zeros((2, 5), "int64")]}, {"causal": True}, True),
    ({}, {"causal": True, "window": 2}, True),
])
def test_fused_attention_flash_dispatch(monkeypatch, ins, attrs, kernel):
    """The forms without a QStart (window and segment ids included) reach
    the flash_attention wrapper (and so its kernels on the card), with
    the Bias broadcast over heads as a [B*H, Tk] key bias and the
    SegmentIds as [B*H, T] ids."""
    calls = []
    real = nn_ops.flash_attention

    def spy(q, k, v, kbias, causal, scale, window, seg):
        calls.append((tuple(q.shape), None if kbias is None
                      else tuple(kbias.shape), causal))
        assert window == attrs.get("window", 0)
        assert (seg is None) == ("SegmentIds" not in ins)
        assert seg is None or tuple(seg.shape) == (6, 5)
        return real(q, k, v, kbias, causal, scale, window, seg)

    monkeypatch.setattr(nn_ops, "flash_attention", spy)
    q = torch.tensor(_F(2, 3, 5, 8))
    feeds = {s: [torch.tensor(a) for a in v] for s, v in ins.items()}
    out = get_op("fused_attention").lower(
        LowerCtx(device="cpu"), dict({"Q": [q], "K": [q], "V": [q]}, **feeds),
        dict({"scale": None, "window": 0}, **attrs))
    assert out["Out"][0].shape == (2, 3, 5, 8)
    if kernel:
        assert calls == [((6, 5, 8), (6, 5) if "Bias" in ins else None,
                          attrs["causal"])]
    else:
        assert calls == []


@pytest.mark.parametrize("shape,begin,scale,bias,kernel", [
    ((2, 3, 8), 2, True, True, True),     # the GPT-2 form
    ((6, 8), 1, True, True, True),
    ((2, 3, 8), 1, True, True, False),    # the norm over two axes
    ((2, 3, 8), 2, True, False, False),   # no Bias
    ((2, 3, 8), 2, False, True, False),   # no Scale
])
def test_layer_norm_dispatch(monkeypatch, shape, begin, scale, bias, kernel):
    """As in the reference: the norm over the last axis with Scale and
    Bias goes to fused_layer_norm (its CUDA kernel on the card); any
    other form is the dense branch, plain PyTorch on any device."""
    calls = []
    real = nn_ops.fused_layer_norm

    def spy(x2d, g, b, eps):
        calls.append(tuple(x2d.shape))
        return real(x2d, g, b, eps)

    monkeypatch.setattr(nn_ops, "fused_layer_norm", spy)
    width = int(np.prod(shape[begin:]))
    ins = {"X": [_F(*shape)]}
    if scale:
        ins["Scale"] = [_F(width)]
    if bias:
        ins["Bias"] = [_F(width)]
    attrs = {"begin_norm_axis": begin, "epsilon": 1e-5}
    ref, out = _run_both("layer_norm", ins, attrs)
    for slot in ref:
        np.testing.assert_allclose(out[slot][0], ref[slot][0], **TOL)
    assert calls == ([(int(np.prod(shape[:-1])), shape[-1])] if kernel else [])


@pytest.mark.parametrize("shape,attrs,kernel", [
    ((6, 2), {}, True),                       # the NSP head
    ((6, 5), {"ignore_index": 2}, False),     # an ignore_index
    ((2, 3, 5), {}, False),                   # 3-D logits
])
def test_softmax_with_cross_entropy_dispatch(monkeypatch, shape, attrs,
                                             kernel):
    """As in the reference: hard labels with no ignore_index over 2-D
    logits go to fused_softmax_xent (its CUDA kernels on the card), every
    other form is the dense branch."""
    from paddle_tpu_torch.ops import math_ops

    calls = []
    real = math_ops.fused_softmax_xent

    def spy(logits, labels):
        calls.append((tuple(logits.shape), tuple(labels.shape)))
        return real(logits, labels)

    monkeypatch.setattr(math_ops, "fused_softmax_xent", spy)
    ins = {"Logits": [_F(*shape)], "Label": [_I(shape[-1], *shape[:-1], 1)]}
    ref, out = _run_both("softmax_with_cross_entropy", ins,
                         dict({"soft_label": False, "ignore_index": -100},
                              **attrs))
    for slot in ref:
        np.testing.assert_allclose(out[slot][0], ref[slot][0], **TOL)
    assert calls == ([(shape, (shape[0],))] if kernel else [])


def test_squeeze_of_a_non_unit_axis_raises():
    with pytest.raises(ValueError, match="size 1"):
        get_op("squeeze2").lower(LowerCtx(device="cpu"),
                                 {"X": [torch.zeros(2, 3)]}, {"axes": [1]})


def _grad_attrs(op_type, fwd_attrs, ins, out_slots, idx=7):
    """The bookkeeping attrs backward.py gives a grad op."""
    return {"__fwd_type__": op_type, "__fwd_attrs__": dict(fwd_attrs),
            "__fwd_in_slots__": list(ins), "__fwd_out_slots__": out_slots,
            "__fwd_out_names__": {s: [s.lower()] for s in out_slots},
            "__fwd_op_idx__": idx}


_GRAD_CASES = {
    name: _CASES[name] for name in (
        "fc_relu", "fc_none", "fused_residual_ln", "fused_linear_xent",
        "fused_linear_xent_tied", "smooth_label_xent", "softmax", "matmul_ty",
        "mul", "lookup_table", "scale", "elementwise_add_axis1",
        "elementwise_mul_axis0", "elementwise_div", "elementwise_sub",
        "reduce_sum_all", "reduce_sum_dim", "dropout_is_test", "dropout_p0",
        "sum", "transpose2", "reshape2", "slice", "unsqueeze2", "clip",
        "layer_norm", "layer_norm_axis1", "fused_attention_causal",
        "fused_attention_bias", "swish", "swish_beta", "expand",
        "expand_every_axis", "rotary_embed", "rotary_embed_pos",
        "rotary_embed_pos_rows", "fused_swiglu", "fused_swiglu_2d", "tanh",
        "mean", "reduce_mean_all", "reduce_mean_dim", "squeeze2",
        "squeeze2_negative", "squeeze2_every_unit_axis",
        "softmax_with_cross_entropy_hard_2d",
        "softmax_with_cross_entropy_hard_2d_flat_label",
        "softmax_with_cross_entropy_ignore_index",
        "softmax_with_cross_entropy_hard_3d")}
_GRAD_CASES["elementwise_pow"] = ("elementwise_pow",
                                  {"X": [np.abs(_F(3)) + 0.5],
                                   "Y": [np.abs(_F(3)) + 0.5]},
                                  {"axis": -1}, False)
_GRAD_CASES["elementwise_min"] = ("elementwise_min",
                                  {"X": [_F(3, 4)], "Y": [_F(3, 4)]},
                                  {"axis": -1}, False)
_GRAD_CASES["matmul_batched"] = ("matmul", {"X": [_F(2, 3, 4, 5)],
                                            "Y": [_F(2, 3, 5, 4)]},
                                 {"transpose_X": False, "transpose_Y": False,
                                  "alpha": 0.5}, False)


@pytest.mark.parametrize("case", sorted(_GRAD_CASES))
def test_grad_lowering_matches_reference(case):
    """<op>_grad through the port's lower_grad_op (torch.func.vjp of the
    forward rule) against the reference's (jax.vjp), with the same
    cotangents for every float output; rtol = atol = 1e-5."""
    import jax.numpy as jnp

    from paddle_tpu.core.registry import lower_grad_op as ref_grad
    from paddle_tpu_torch.core.registry import lower_grad_op

    op_type, ins, attrs, _ = _GRAD_CASES[case]
    fwd, _ = _run_both(op_type, ins, attrs)
    out_slots = list(fwd)
    cots = {s + "@GRAD": [_F(*a.shape) if a.shape else np.float32(_R.randn())
                          for a in fwd[s]]
            for s in out_slots if np.issubdtype(fwd[s][0].dtype, np.floating)}
    gattrs = _grad_attrs(op_type, attrs, ins, out_slots)
    gins = dict(ins, **cots)
    ref = ref_grad(RefCtx(), None,
                   {s: [jnp.asarray(a) for a in v] for s, v in gins.items()},
                   gattrs)
    out = lower_grad_op(LowerCtx(device="cpu"),
                        {s: [torch.tensor(np.asarray(a)) for a in v]
                         for s, v in gins.items()}, gattrs)
    assert set(out) == set(ref), (case, set(out), set(ref))
    for slot in ref:
        for a, b in zip(ref[slot], out[slot]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-5, err_msg=slot)


def test_dropout_grad_redraws_the_forward_mask():
    """The grad op re-runs dropout under the forward op's index
    (__fwd_op_idx__) and so draws the forward's mask: the gradient is the
    cotangent times that mask.  The index is the op's plain position,
    which equals the runner's (block << 20) | idx in block 0, the block a
    training program differentiates (as in the reference)."""
    from paddle_tpu_torch.core.registry import lower_grad_op

    x = torch.tensor(_F(64, 32))
    attrs = {"dropout_prob": 0.5, "is_test": False, "seed": 0,
             "dropout_implementation": "downgrade_in_infer"}
    ctx = LowerCtx(seed=11, device="cpu")
    ctx.op_idx = (0 << 20) | 5
    fwd = get_op("dropout").lower(ctx, {"X": [x]}, attrs)
    mask = fwd["Mask"][0]
    assert 0.3 < float(mask.mean()) < 0.7
    dy = torch.tensor(_F(64, 32))
    gctx = LowerCtx(seed=11, device="cpu")
    gctx.op_idx = 99  # the grad op's own position must not matter
    g = lower_grad_op(gctx, {"X": [x], "Out@GRAD": [dy]},
                      _grad_attrs("dropout", attrs, {"X": None},
                                  ["Out", "Mask"], idx=5))
    np.testing.assert_array_equal(g["X@GRAD"][0].numpy(),
                                  (dy * mask).numpy())
    other = lower_grad_op(gctx, {"X": [x], "Out@GRAD": [dy]},
                          _grad_attrs("dropout", attrs, {"X": None},
                                      ["Out", "Mask"], idx=6))
    assert not torch.equal(other["X@GRAD"][0], g["X@GRAD"][0])


def test_sparse_lookup_table_gradient_raises():
    """is_sparse: the reference's SelectedRows gradient and lazy Adam are
    not ported (ROADMAP A1), so the gradient raises instead of training
    every row densely; the forward (inference) still runs."""
    from paddle_tpu_torch.core.registry import lower_grad_op

    ins = {"W": [_F(11, 6)], "Ids": [_I(11, 3, 4)]}
    attrs = {"padding_idx": -1, "is_sparse": True}
    ref, out = _run_both("lookup_table", ins, attrs)
    np.testing.assert_array_equal(out["Out"][0], ref["Out"][0])
    gins = dict(ins, **{"Out@GRAD": [_F(3, 4, 6)]})
    with pytest.raises(NotImplementedError, match="ROADMAP A1"):
        lower_grad_op(LowerCtx(device="cpu"),
                      {s: [torch.tensor(a) for a in v]
                       for s, v in gins.items()},
                      _grad_attrs("lookup_table", attrs, ins, ["Out"]))


def _ref_and_port_grads(op_type, ins, attrs, cot):
    """The reference's and the port's grad of `op_type` for the output
    cotangent `cot`."""
    import jax.numpy as jnp

    from paddle_tpu.core.registry import lower_grad_op as ref_grad
    from paddle_tpu_torch.core.registry import lower_grad_op

    gattrs = _grad_attrs(op_type, attrs, ins, ["Out"])
    gins = dict(ins, **{"Out@GRAD": [cot]})
    ref = ref_grad(RefCtx(), None,
                   {s: [jnp.asarray(a) for a in v] for s, v in gins.items()},
                   gattrs)
    out = lower_grad_op(LowerCtx(device="cpu"),
                        {s: [torch.tensor(a) for a in v]
                         for s, v in gins.items()}, gattrs)
    return ref, out


def test_clip_gradient_splits_ties_as_the_reference():
    """clip(1, 2) at x = [0.5, 1, 1.5, 2, 2.5]: the gradient is 0.5 at
    both bounds, as jnp.clip's."""
    x = np.array([0.5, 1.0, 1.5, 2.0, 2.5], "float32")
    ref, out = _ref_and_port_grads("clip", {"X": [x]},
                                   {"min": 1.0, "max": 2.0},
                                   np.ones(5, "float32"))
    np.testing.assert_array_equal(out["X@GRAD"][0].numpy(),
                                  np.asarray(ref["X@GRAD"][0]))
    np.testing.assert_array_equal(out["X@GRAD"][0].numpy(),
                                  [0.0, 0.5, 1.0, 0.5, 0.0])


def test_relu_gradients_at_zero_match_the_reference():
    """The relu op and fc's relu epilogue (the matmul_bias_act backward)
    give the gradient 0.5 at an exact 0, as jnp.maximum's."""
    x = np.array([[-1.0, 0.0, 2.0]], "float32")
    ref, out = _ref_and_port_grads("relu", {"X": [x]}, {},
                                   np.ones((1, 3), "float32"))
    np.testing.assert_array_equal(out["X@GRAD"][0].numpy(),
                                  np.asarray(ref["X@GRAD"][0]))
    np.testing.assert_array_equal(out["X@GRAD"][0].numpy(),
                                  [[0.0, 0.5, 1.0]])
    # fc: x @ I + 0 puts the pre-activation at exactly [-1, 0, 2]
    fc_ins = {"Input": [x], "W": [np.eye(3, dtype="float32")],
              "Bias": [np.zeros(3, "float32")]}
    attrs = {"in_num_col_dims": 1, "activation_type": "relu"}
    ref, out = _ref_and_port_grads("fc", fc_ins, attrs,
                                   np.ones((1, 3), "float32"))
    for slot in ("Input@GRAD", "W@GRAD", "Bias@GRAD"):
        np.testing.assert_array_equal(out[slot][0].numpy(),
                                      np.asarray(ref[slot][0]))
    np.testing.assert_array_equal(out["Bias@GRAD"][0].numpy(),
                                  [0.0, 0.5, 1.0])
