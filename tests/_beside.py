"""A test module's function run in a child process beside the test, so
that JAX's reference compiles (once per shape and function, and Python-
bound while they trace) overlap the work of the test's own process.

    wait = beside(work_dir, "tests.test_torch_bundle", "_jax_refs", *args)
    ...                      # the test's own work meanwhile
    result = wait()          # the function's return value (pickled)

The child imports tests/conftest.py first, so its JAX runs on the same
8 CPU devices as the tests'. Inputs and results cross as pickles under
`work_dir`; a failing child fails the caller with its log.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 600

CHILD = """
import importlib
import pickle
import sys
import tests.conftest  # noqa: F401 (JAX on 8 CPU devices, as in the tests)
with open(sys.argv[1], "rb") as f:
    module, name, args = pickle.load(f)
result = getattr(importlib.import_module(module), name)(*args)
with open(sys.argv[2], "wb") as f:
    pickle.dump(result, f)
"""


def beside(work, module: str, name: str, *args):
    """Start `module.name(*args)` in a child process; returns a function
    that waits for it and gives its result (the same object on every call)."""
    src = os.path.join(str(work), f"{name}_in.pkl")
    dst = os.path.join(str(work), f"{name}_out.pkl")
    with open(src, "wb") as f:
        pickle.dump((module, name, args), f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", CHILD, src, dst], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    done = []

    def result():
        if not done:
            try:
                log = proc.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace")
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            assert proc.returncode == 0, f"{module}.{name} failed:\n{log[-4000:]}"
            with open(dst, "rb") as f:
                done.append(pickle.load(f))
        return done[0]

    return result
