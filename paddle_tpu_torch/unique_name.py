"""Unique name generator for variables/parameters (the counterpart of
``paddle_tpu/unique_name.py``): a process-wide counter per key plus a
``guard`` so parameter names like ``fc_0.w_0`` are stable across a
program build.  Both packages generate the same names for the same
builder calls, which is what lets weights cross between them by name.
"""

import contextlib
import threading


class UniqueNameGenerator:
    def __init__(self, prefix=""):
        self.ids = {}
        self.prefix = prefix
        self._lock = threading.Lock()

    def __call__(self, key):
        with self._lock:
            tmp = self.ids.get(key, 0)
            self.ids[key] = tmp + 1
        return self.prefix + "_".join([key, str(tmp)])


generator = UniqueNameGenerator()


def generate(key):
    return generator(key)


def switch(new_generator=None):
    global generator
    old = generator
    generator = new_generator if new_generator is not None else UniqueNameGenerator()
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    if isinstance(new_generator, str):
        new_generator = UniqueNameGenerator(new_generator)
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
