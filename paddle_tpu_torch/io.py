"""Model save / load (the counterpart of ``paddle_tpu/io.py``).

Persistence is a host-side operation over the scope, in the reference's
layout: one ``<name>.npy`` per var (``/`` written as ``%2F``), or one
``np.savez`` blob under ``filename=``; the inference model's program is
the reference's JSON ``__model__`` (``{"version", "program",
"feed_names", "fetch_names"}``), so a model saved by either package
loads in the other.  The loaders put tensors on the executor's place
(``executor.place``; the card when the executor is None).  The binary
protobuf ``__model__`` (``model_format="pb"``, the reference's
``desc_codec``) is not ported (ROADMAP A9).

``params_from_numpy`` puts a ``{name: np.ndarray}`` dict (for example a
scope of the reference package, read out as numpy) into a scope as
tensors on a place.
"""

import json
import os

import numpy as np
import torch

from . import framework
from .core.scope import global_scope
from .framework import Parameter, Program
from .places import default_place

# The serialized program's format version (the reference's framework.proto
# Version): the loader accepts every version <= the current one (0: the
# era before the field) and refuses newer ones.
PROGRAM_FORMAT_VERSION = 1

__all__ = [
    "PROGRAM_FORMAT_VERSION",
    "is_program_version_supported",
    "get_program_persistable_vars",
    "save_vars",
    "save_params",
    "save_persistables",
    "load_vars",
    "load_params",
    "load_persistables",
    "save_inference_model",
    "load_inference_model",
    "params_from_numpy",
]


def is_program_version_supported(version):
    return 0 <= int(version) <= PROGRAM_FORMAT_VERSION


def get_program_persistable_vars(program):
    return [v for v in program.list_vars() if v.persistable]


def _host(value):
    """A scope value as a numpy array (a tensor on any device, or an
    array)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _device(executor):
    """The torch device the loaders put tensors on."""
    place = executor.place if executor is not None else default_place()
    return place.torch_device()


def _var_path(dirname, name):
    return os.path.join(dirname, name.replace("/", "%2F") + ".npy")


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None, scope=None):
    if main_program is None:
        main_program = framework.default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    os.makedirs(dirname, exist_ok=True)
    scope = scope if scope is not None else global_scope()
    if filename is not None:
        blob = {}
        for v in vars:
            val = scope.find_var(v.name)
            if val is not None:
                blob[v.name] = _host(val)
        np.savez(os.path.join(dirname, filename), **blob)
        return
    for v in vars:
        val = scope.find_var(v.name)
        if val is not None:
            np.save(_var_path(dirname, v.name), _host(val))


def save_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    if main_program is None:
        main_program = framework.default_main_program()
    save_vars(executor, dirname, main_program,
              vars=[v for v in main_program.list_vars()
                    if isinstance(v, Parameter)],
              filename=filename, scope=scope)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    if main_program is None:
        main_program = framework.default_main_program()
    save_vars(executor, dirname, main_program,
              vars=get_program_persistable_vars(main_program),
              filename=filename, scope=scope)


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None, scope=None):
    """Each var's saved array into `scope` as a tensor on the executor's
    place; a var with no file is skipped, as in the reference."""
    if main_program is None:
        main_program = framework.default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars()
                if predicate is None or predicate(v)]
    scope = scope if scope is not None else global_scope()
    device = _device(executor)
    if filename is not None:
        blob = np.load(os.path.join(dirname, filename))
        for v in vars:
            if v.name in blob:
                scope.set(v.name, torch.tensor(blob[v.name], device=device))
        return
    for v in vars:
        try:
            arr = np.load(_var_path(dirname, v.name))
        except FileNotFoundError:
            continue
        scope.set(v.name, torch.tensor(arr, device=device))


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    if main_program is None:
        main_program = framework.default_main_program()
    load_vars(executor, dirname, main_program,
              vars=[v for v in main_program.list_vars()
                    if isinstance(v, Parameter)],
              filename=filename, scope=scope)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    if main_program is None:
        main_program = framework.default_main_program()
    load_vars(executor, dirname, main_program,
              vars=get_program_persistable_vars(main_program),
              filename=filename, scope=scope)


def _pb_not_ported():
    return NotImplementedError(
        "the binary protobuf __model__ (desc_codec) is not ported yet "
        "(ROADMAP A9): save with model_format='json'")


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         scope=None, model_format="json"):
    """Prune a clone(for_test=True) of the program to the targets, then
    write its JSON ``__model__`` and its persistables.  Returns the
    fetch names."""
    if model_format == "pb":
        raise _pb_not_ported()
    if model_format != "json":
        raise ValueError("model_format must be 'json' or 'pb', got %r"
                         % model_format)
    if main_program is None:
        main_program = framework.default_main_program()
    os.makedirs(dirname, exist_ok=True)
    pruned = main_program.clone(for_test=True)._prune(target_vars)
    feed_names = list(feeded_var_names)
    fetch_names = [t.name if isinstance(t, framework.Variable) else t
                   for t in target_vars]
    meta = {"version": PROGRAM_FORMAT_VERSION, "program": pruned.to_json(),
            "feed_names": feed_names, "fetch_names": fetch_names}
    with open(os.path.join(dirname, model_filename or "__model__"), "w") as f:
        json.dump(meta, f)
    save_persistables(executor, dirname, pruned, filename=params_filename,
                      scope=scope)
    return fetch_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, scope=None):
    """(program, feed names, fetch Variables); the persistables go into
    `scope` (default: the global scope) on the executor's place."""
    path = os.path.join(dirname, model_filename or "__model__")
    with open(path, "rb") as f:
        raw = f.read()
    if not bytes(raw[:16]).lstrip().startswith(b"{"):
        raise _pb_not_ported()
    meta = json.loads(raw.decode("utf-8"))
    version = meta.get("version", 0)  # models before the field load as 0
    if not is_program_version_supported(version):
        raise RuntimeError(
            "saved model format version %s is newer than this build "
            "supports (<= %d) — upgrade paddle_tpu_torch to load it"
            % (version, PROGRAM_FORMAT_VERSION))
    program = Program.from_json(meta["program"])
    feed_names, fetch_names = meta["feed_names"], meta["fetch_names"]
    load_persistables(executor, dirname, program, filename=params_filename,
                      scope=scope)
    fetch_vars = [program.global_block().var(n) for n in fetch_names]
    return program, feed_names, fetch_vars


def params_from_numpy(arrays, scope=None, place=None):
    """Copy every array into `scope` (default: the global scope) as a
    tensor on `place` (default: ``default_place()``, the card, which
    raises where there is none: pass ``CPUPlace()`` for the CPU).
    Returns the names set."""
    scope = scope if scope is not None else global_scope()
    device = (place if place is not None else default_place()).torch_device()
    for name, arr in arrays.items():
        scope.set(name, torch.tensor(np.asarray(arr), device=device))
    return sorted(arrays)
