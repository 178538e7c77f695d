"""Inference-time program rewrites (the counterpart of
``paddle_tpu/transpiler/inference_transpiler.py``), each also a
registry pass:

* ``bn_fold_pass`` — fold batch_norm (inference form) into the
  preceding conv2d / depthwise_conv2d / fc / mul by rewriting the
  weight and bias in the scope, looking through an optional bias add
  and an optional pure ``scale`` link.  The arithmetic is the
  reference's, in numpy float32 on host copies of the scope's values,
  so the folded weights are bit-equal to the reference's; they go back
  as tensors onto the weight's device.
* ``train_prune_pass`` — dropout to its is_test form and, with a fetch
  cut (``program._protected_fetch_names``), everything below it sliced
  away.

``InferenceTranspiler.transpile`` runs them in the reference's order.
The reference's weight-only int8 stamp waits for ``contrib/quantize``
(ROADMAP A6c).
"""

import numpy as np
import torch

# op type -> (weight input slot, output slot, how a per-channel scale
# vector reshapes onto the weight)
_BN_FOLD_PRODUCERS = {
    "conv2d": ("Filter", "Output",
               lambda s, w: s.reshape((-1,) + (1,) * (w.ndim - 1))),
    "depthwise_conv2d": ("Filter", "Output",
                         lambda s, w: s.reshape((-1,) + (1,) * (w.ndim - 1))),
    # fc / mul: weight [D_in, C_out], the channel axis LAST
    "fc": ("W", "Out", lambda s, w: s.reshape(1, -1)),
    "mul": ("Y", "Out", lambda s, w: s.reshape(1, -1)),
}


def _host_f32(value):
    """A float32 numpy copy of a scope value (a tensor on any device, or
    an array)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.array(value, dtype=np.float32)


def _device_of(value):
    return value.device if isinstance(value, torch.Tensor) else \
        torch.device("cpu")


class InferenceTranspiler:
    def transpile(self, program, place=None, scope=None, fetches=None,
                  quantize_int8=False, int8_min_elems=1024):
        """Run the inference pass pipeline in place and return the
        program.  fetches: optional fetch-target names (or Variables)
        defining the inference cut: ops below it are pruned first, and
        the names are recorded as ``_protected_fetch_names`` so that no
        later pass folds a fetched value away."""
        from ..core.scope import global_scope

        if quantize_int8:
            raise NotImplementedError(
                "InferenceTranspiler.transpile(quantize_int8=True): the "
                "weight-only int8 stamp (contrib/quantize) is not ported "
                "yet (ROADMAP A6c)")
        scope = scope if scope is not None else global_scope()
        if fetches:
            names = tuple(
                f.name if hasattr(f, "name") else str(f) for f in fetches)
            existing = tuple(
                getattr(program, "_protected_fetch_names", ()) or ())
            program._protected_fetch_names = tuple(
                dict.fromkeys(existing + names))
            # prune FIRST: a cloned train program's backward ops read
            # every forward intermediate, which would make the fold's
            # single-consumer checks refuse everything
            self._prune_to_fetches(program)
        self._fold_batch_norm(program, scope)
        self._drop_train_ops(program)
        program._is_test = True
        program._bump_version()
        return program

    # ------------------------------------------------------------------
    def _drop_train_ops(self, program):
        """Each dropout becomes its inference form: a scale op by (1 - p)
        for downgrade_in_infer, else the identity (its producer renamed
        to write the dropout's output, or its readers aliased)."""
        from .. import framework as _fw

        block = program.global_block()
        consumers = self._consumer_count(block)
        new_ops = []
        alias = {}
        for op in block.ops:
            for slot, names in op.inputs.items():
                op.inputs[slot] = [alias.get(n, n) for n in names]
            if op.type == "dropout":
                out, x = op.outputs["Out"][0], op.inputs["X"][0]
                impl = op.attrs.get("dropout_implementation",
                                    "downgrade_in_infer")
                if impl != "upscale_in_train":
                    sc = _fw.Operator(
                        block, "scale", None, None,
                        {"scale": 1.0 - float(op.attrs.get("dropout_prob",
                                                           0.5))})
                    sc.inputs = {"X": [x]}
                    sc.outputs = {"Out": [out]}
                    new_ops.append(sc)
                    continue
                if consumers.get(x, 0) == 1 and new_ops:
                    # sole consumer: the producer writes the dropout's
                    # output name, so fetches of `out` keep working
                    for prev in reversed(new_ops):
                        renamed = False
                        for slot, names in prev.outputs.items():
                            if x in names:
                                prev.outputs[slot] = [
                                    out if n == x else n for n in names]
                                renamed = True
                        if renamed:
                            break
                    else:
                        alias[out] = x
                else:
                    alias[out] = x
                continue
            new_ops.append(op)
        block.ops = new_ops

    # ------------------------------------------------------------------
    def _prune_to_fetches(self, program):
        """Slice the global block to the ancestor ops of the protected
        fetch names (framework.backward_slice_keep, the walk behind
        Program._prune); returns how many ops went."""
        from ..framework import backward_slice_keep

        targets = set(getattr(program, "_protected_fetch_names", ()) or ())
        if not targets:
            return 0
        block = program.global_block()
        keep = backward_slice_keep(program, targets)
        dropped = sum(1 for k in keep if not k)
        if dropped:
            block.ops = [op for i, op in enumerate(block.ops) if keep[i]]
            program._bump_version()
        return dropped

    # ------------------------------------------------------------------
    def _producer_map(self, block):
        from ..analysis.graph import producer_map

        return producer_map(block)

    def _consumer_count(self, block):
        from ..analysis.graph import consumer_count

        return consumer_count(block)

    def _fold_batch_norm(self, program, scope):
        """producer (+ bias add) (+ pure scale) -> batch_norm  ==>
        producer with W' = W*s*g/std, b' = (b*s - mean)*g/std + beta.

        Producers: conv2d / depthwise_conv2d (per output channel, axis
        0), fc / mul (per output column, last axis).  A trailing relu is
        untouched and stays eligible for the conv fuse passes.  The
        scale link must be a pure multiply (bias 0).  Default closed and
        all or nothing: a missing scope value, a link with more than one
        reader, an unknown producer or two biases leave the chain alone,
        checked before anything is rewritten."""
        block = program.global_block()
        prod = self._producer_map(block)
        consumers = self._consumer_count(block)
        protected = set(getattr(program, "_protected_fetch_names", ()) or ())
        drop = set()

        for i, op in enumerate(block.ops):
            if op.type != "batch_norm":
                continue
            # inference-form BN only: a train-mode BN normalizes by the
            # batch's statistics
            if not (op.attrs.get("is_test", False)
                    or getattr(program, "_is_test", False)):
                continue
            x = op.inputs["X"][0]
            if consumers.get(x, 0) != 1 or x not in prod:
                continue
            if x in protected:
                continue  # the fold deletes this name's definition
            cur = block.ops[prod[x]]
            s_factor = 1.0
            scale_op_idx = None
            if cur.type == "scale":
                if float(cur.attrs.get("bias", 0.0)) != 0.0:
                    continue
                sx = cur.inputs["X"][0]
                if consumers.get(sx, 0) != 1 or sx not in prod:
                    continue
                if sx in protected:
                    continue
                s_factor = float(cur.attrs.get("scale", 1.0))
                scale_op_idx = prod[x]
                cur = block.ops[prod[sx]]
            bias_add = None
            if cur.type == "elementwise_add":
                ax = cur.inputs["X"][0]
                if consumers.get(ax, 0) != 1 or ax not in prod:
                    continue
                if ax in protected:
                    continue
                bias_add = cur
                cur = block.ops[prod[ax]]
            handler = _BN_FOLD_PRODUCERS.get(cur.type)
            if handler is None:
                continue
            w_slot, out_slot, reshape_scale = handler
            if cur.type == "fc" and cur.attrs.get("activation_type"):
                continue  # BN(act(xW+b)) has no affine fold
            if cur.type == "mul" and int(
                    cur.attrs.get("y_num_col_dims", 1)) != 1:
                continue
            if cur.type == "mul" and bias_add is None:
                continue  # a bare mul has nowhere to put the shift

            def val(slot):
                v = scope.find_var(op.inputs[slot][0])
                return None if v is None else _host_f32(v)

            gamma, beta = val("Scale"), val("Bias")
            mean, var = val("Mean"), val("Variance")
            if any(v is None for v in (gamma, beta, mean, var)):
                continue
            eps = float(op.attrs.get("epsilon", 1e-5))
            std = np.sqrt(var + eps)

            wname = cur.inputs[w_slot][0]
            wvar = scope.find_var(wname)
            if wvar is None:
                continue
            w = _host_f32(wvar)
            n_ch = (w.shape[0] if cur.type.endswith("conv2d")
                    else w.shape[-1])
            if gamma.shape != (n_ch,):
                continue

            # resolve the bias before any mutation (all or nothing)
            new_bias_name = None
            if bias_add is not None and cur.inputs.get("Bias"):
                continue  # two biases: folding one would be wrong
            if bias_add is not None:
                bname = bias_add.inputs["Y"][0]
                bv = scope.find_var(bname)
                if bv is None:
                    continue
                b = _host_f32(bv).reshape(-1)
            elif cur.inputs.get("Bias"):
                bname = cur.inputs["Bias"][0]
                bv = scope.find_var(bname)
                if bv is None:
                    continue
                b = _host_f32(bv)
            else:
                bname = new_bias_name = wname + "@BN_FOLDED_BIAS"
                b = np.zeros(n_ch, dtype=np.float32)

            # every precondition holds: rewrite weight and bias together
            device = _device_of(wvar)
            scope.set(wname, torch.from_numpy(w * reshape_scale(
                np.asarray(s_factor * gamma / std, np.float32),
                w)).to(device))
            if new_bias_name is not None:
                block.create_var(name=new_bias_name, shape=[int(n_ch)],
                                 dtype="float32", persistable=True)
                cur.inputs["Bias"] = [new_bias_name]
            scope.set(bname, torch.from_numpy(np.ascontiguousarray(
                (b * s_factor - mean) * gamma / std + beta)).to(device))

            # the op feeding bn now writes the bn output name directly
            tail = bias_add if bias_add is not None else cur
            t_slot = ("Out" if tail.type in ("elementwise_add", "fc", "mul")
                      else out_slot)
            tail.outputs[t_slot] = [op.outputs["Y"][0]]
            drop.add(i)
            if scale_op_idx is not None:
                drop.add(scale_op_idx)

        if drop:
            block.ops = [op for j, op in enumerate(block.ops) if j not in drop]
            program._bump_version()
