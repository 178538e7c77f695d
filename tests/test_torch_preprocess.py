"""The in-graph preprocessing slice on the CPU: the ``random_crop`` op
and layer, and ``build_resnet_preprocess_train_program`` (uint8 HWC
images cropped, cast, transposed, scaled and normalized inside the
training step), against the reference.

- ``random_crop``: the output's shape and dtype; the output equals the
  input's window at one in-range offset shared by the whole batch
  (leading dims not cropped); the offsets vary across steps (the
  executor folds its step into the op's draw); the identity at zero
  margin; SeedOut written (0), Seed a no-grad input.  Its draws cannot
  match the reference's threefry stream, so the op is held to its
  contract, not to the reference's offsets.
- The program, f32 and bf16, NCHW and NHWC, op for op through
  ``Program.to_json`` (vars up to the dtype policy).
- Three Momentum steps of the program at raw_margin 0 (the crop is the
  identity in both packages) at 64 x 64, batch 4, from the port's
  startup state, each step run from the reference's state before it: the normalized image within 1e-6
  absolute of the reference's, the loss within rtol 1e-4 (a float32
  sum through ResNet-50's 53 batch norms; 9.2e-6 measured).  Only each
  step's loss is held: at batch 4 the last batch norms normalize 16
  values, and a float32 difference of 1e-4 there moves a relu input's
  sign, so a gradient element moves by its whole value (the
  reference's own NCHW and NHWC runs agree because XLA picks the same
  algorithms for both).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu.models import resnet as ref_resnet
import paddle_tpu_torch as ptt
from paddle_tpu_torch import framework, unique_name
from paddle_tpu_torch.core import registry
from paddle_tpu_torch.core import scope as scope_mod
from paddle_tpu_torch.io import params_from_numpy
from paddle_tpu_torch.models import resnet as port_resnet


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


def _crop_program(raw, crop, pkg=ptt):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        img = pkg.layers.data("img", shape=list(raw), dtype="uint8")
        out = pkg.layers.random_crop(img, shape=list(crop))
    return main, out


def _window(x, out, crop):
    """The offsets (i, j) at which out is x's window, the same for every
    image of the batch; None if there is none."""
    h, w = crop[0], crop[1]
    for i in range(x.shape[1] - h + 1):
        for j in range(x.shape[2] - w + 1):
            if np.array_equal(out, x[:, i:i + h, j:j + w, :]):
                return i, j
    return None


def test_random_crop_takes_one_window_for_the_batch():
    raw, crop = (12, 15, 3), (7, 9, 3)
    main, out = _crop_program(raw, crop)
    x = np.random.RandomState(0).randint(0, 256, (4,) + raw).astype("uint8")
    exe = ptt.Executor(ptt.CPUPlace())
    seen = set()
    for _ in range(8):
        got, seed_out = exe.run(main, feed={"img": x},
                                fetch_list=[out, main.global_block().ops[0]
                                            .outputs["SeedOut"][0]])
        assert got.shape == (4,) + crop and got.dtype == np.uint8
        at = _window(x, got, crop)
        assert at is not None
        assert 0 <= at[0] <= raw[0] - crop[0] and 0 <= at[1] <= raw[1] - crop[1]
        seen.add(at)
        assert seed_out.tolist() == [0]
    assert len(seen) > 1  # each step draws its own offsets


def test_random_crop_is_the_identity_at_zero_margin():
    raw = (6, 5, 3)
    main, out = _crop_program(raw, raw)
    x = np.random.RandomState(1).randint(0, 256, (2,) + raw).astype("uint8")
    exe = ptt.Executor(ptt.CPUPlace())
    for _ in range(3):
        np.testing.assert_array_equal(
            exe.run(main, feed={"img": x}, fetch_list=[out])[0], x)


def test_random_crop_op_contract():
    """The reference's op: a float X crops the same way and its grad
    reaches the window only; Seed is a no-grad input; a crop larger than
    X raises; the layer's program is the reference's."""
    assert "Seed" in registry.get_op("random_crop").no_grad_inputs
    r_main, _ = _crop_program((8, 8, 3), (5, 6, 3), fluid)
    p_main, _ = _crop_program((8, 8, 3), (5, 6, 3))
    assert json.loads(r_main.to_json())["blocks"][0]["ops"] == \
        json.loads(p_main.to_json())["blocks"][0]["ops"]
    lower = registry.get_op("random_crop").lower
    ctx = registry.LowerCtx(seed=5)
    x = torch.arange(2 * 6 * 7, dtype=torch.float32).reshape(2, 6, 7)
    out = lower(ctx, {"X": [x]}, {"shape": [3, 4]})["Out"][0]
    i, j = [int(v) for v in torch.nonzero(x[0] == out[0, 0, 0])[0]]
    assert torch.equal(out, x[:, i:i + 3, j:j + 4])
    xg = x.clone().requires_grad_()
    again = lower(registry.LowerCtx(seed=5), {"X": [xg]},
                  {"shape": [3, 4]})["Out"][0]
    assert torch.equal(again, out)  # the same seed, the same window
    (g,) = torch.autograd.grad(again.sum(), xg)
    assert float(g.sum()) == again.numel()
    assert torch.equal(g[:, i:i + 3, j:j + 4], torch.ones(2, 3, 4))
    with pytest.raises(ValueError, match="does not fit"):
        lower(ctx, {"X": [x]}, {"shape": [7, 4]})


def _same_json(ref, port):
    r, p = json.loads(ref.to_json()), json.loads(port.to_json())
    assert p["blocks"][0]["ops"] == r["blocks"][0]["ops"]

    def norm(v):
        return dict(v, dtype={"int32": "int64"}.get(v["dtype"], v["dtype"]))

    assert ([norm(v) for v in p["blocks"][0]["vars"]]
            == [norm(v) for v in r["blocks"][0]["vars"]])


@pytest.mark.parametrize("use_bf16", [False, True])
@pytest.mark.parametrize("use_nhwc", [False, True])
def test_preprocess_program_matches_reference(use_bf16, use_nhwc):
    kw = dict(image_shape=(32, 32, 3), class_dim=10, use_bf16=use_bf16,
              use_nhwc=use_nhwc)
    with fluid.unique_name.guard():
        r_main, r_start, r_feeds, r_fetch = \
            ref_resnet.build_resnet_preprocess_train_program(**kw)
    with unique_name.guard():
        p_main, p_start, p_feeds, p_fetch = \
            port_resnet.build_resnet_preprocess_train_program(**kw)
    _same_json(r_main, p_main)
    _same_json(r_start, p_start)
    assert p_feeds == r_feeds == ["image", "label"]
    assert [v.name for v in p_fetch] == [v.name for v in r_fetch]
    block = p_main.global_block()
    assert block.var("image").dtype == "uint8"
    assert list(block.var("image").shape) == [-1, 64, 64, 3]
    types = [o.type for o in block.ops]
    assert types[:3] == ["random_crop", "cast", "transpose2"]
    assert ("bfloat16" in {v.dtype for v in block.vars.values()}) == use_bf16


def test_preprocess_training_matches_reference():
    S, B = 64, 4
    rng = np.random.RandomState(0)
    batch = {"image": rng.randint(0, 256, (B, S, S, 3)).astype("uint8"),
             "label": rng.randint(0, 10, (B, 1)).astype("int64")}
    kw = dict(image_shape=(S, S, 3), class_dim=10, lr=0.01, raw_margin=0)
    with unique_name.guard():
        port_main, port_start, _, port_fetch = \
            port_resnet.build_resnet_preprocess_train_program(**kw)
    with fluid.unique_name.guard():
        main, _, _, fetch = \
            ref_resnet.build_resnet_preprocess_train_program(**kw)
    normed = [o for o in main.global_block().ops
              if o.type == "elementwise_div"][0].outputs["Out"][0]
    block = main.global_block()
    names = [n for n, v in block.vars.items() if v.persistable]
    # the start state comes from the port's startup (the reference's
    # would compile ResNet-50's initializers in XLA for this one use),
    # in the reference's dtypes
    start_scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(port_start, scope=start_scope)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    states, losses, images = [], [], []
    with fluid.scope_guard(scope):
        for n in names:
            scope.set(n, jnp.asarray(start_scope.find_var(n).numpy().astype(
                block.var(n).dtype)))
        states.append({n: np.asarray(scope.find_var(n)) for n in names})
        for _ in range(3):
            loss, img = exe.run(main, feed=batch, fetch_list=[fetch[0], normed])
            losses.append(float(np.asarray(loss).sum()))
            images.append(np.asarray(img))
            states.append({n: np.asarray(scope.find_var(n)) for n in names})
    main, fetch = port_main, port_fetch
    exe = ptt.Executor(ptt.CPUPlace())
    for k in range(3):
        scope = ptt.Scope()
        params_from_numpy(states[k], scope, ptt.CPUPlace())
        loss, img = exe.run(main, feed=batch, fetch_list=[fetch[0], normed],
                            scope=scope)
        assert img.shape == (B, 3, S, S) and img.dtype == np.float32
        np.testing.assert_allclose(img, images[k], rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(loss.sum()), losses[k], rtol=1e-4)
        moved = [n for n in names
                 if not np.array_equal(scope.find_var(n).numpy(),
                                       states[k][n])]
        assert len(moved) > len(names) // 2
