"""Device places (the counterpart of ``paddle_tpu/places.py``):
``CPUPlace`` and ``CUDAPlace(i)``, each naming the ``torch.device`` an
Executor runs on.

``default_place()`` is ``CUDAPlace(0)``.  Where no CUDA device is
present it raises: a run that silently lands on the CPU would report
CPU numbers under a GPU's name.  Callers that want the CPU ask for it
with ``CPUPlace()``.

``is_compiled_with_cuda()`` reports whether torch was built with CUDA,
as the reference's ``is_compiled_with_tpu()`` reports its accelerator.
The reference's ``TPUPlace``, ``TPUPinnedPlace``, ``tpu_places`` and
``is_compiled_with_tpu`` name the TPU and have no counterpart here.
"""

import torch

__all__ = ["CPUPlace", "CUDAPlace", "default_place", "is_compiled_with_cuda"]


class Place:
    device_id = 0

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))


class CPUPlace(Place):
    def __repr__(self):
        return "CPUPlace"

    def torch_device(self):
        return torch.device("cpu")


class CUDAPlace(Place):
    def __init__(self, device_id=0):
        self.device_id = int(device_id)

    def __repr__(self):
        return "CUDAPlace(%d)" % self.device_id

    def torch_device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDAPlace(%d): no CUDA device is available; pass "
                "CPUPlace() to run on the CPU" % self.device_id)
        return torch.device("cuda", self.device_id)


def default_place():
    """CUDAPlace(0); raises when no CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass CPUPlace() explicitly to run "
            "on the CPU (there is no silent fallback)")
    return CUDAPlace(0)


def is_compiled_with_cuda():
    """Whether this torch was built with CUDA (a card may still be
    absent: ``torch.cuda.is_available()`` says that)."""
    return torch.backends.cuda.is_built()
