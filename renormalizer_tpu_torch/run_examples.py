"""Run the package's examples (``examples/*.py``) through the port.

The port's counterpart of ``examples/run.sh``::

    python -m renormalizer_tpu_torch.run_examples [--timeout 60] [name ...]

Each example is read as text from the repository's ``examples/``, its
``renormalizer_tpu`` imports rewritten to ``renormalizer_tpu_torch``
(:func:`rewrite`), written to a temporary directory and run in a process of
its own from the repository root.  ``run.sh``'s rule decides: an example
passes when it exits 0 or is still running at the time limit.  The device
and precision are the port's defaults (``RENO_PLATFORM``, ``RENO_DTYPE``):
on the card when there is one; ``RENO_PLATFORM=cpu RENO_DTYPE=fp64`` runs
them on the CPU.  The script prints each example's seconds and the tail of
its output, and exits 1 if one failed.

:func:`run_example` runs one example in the calling process and returns
what it printed; :func:`run_in_subprocess` runs one in a process of its own
and can bring back the numbers its module left behind (``--dump``).
"""

import argparse
import contextlib
import io
import json
import logging
import os
import re
import runpy
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")

TAIL = 5  # lines of each example's output that the script prints

# `\b` after the name: `renormalizer_tpu_torch` continues with a word
# character, so names already in the port stay as they are
_JAX_PACKAGE = re.compile(r"\brenormalizer_tpu\b")


def rewrite(source: str) -> str:
    """``source`` with every ``renormalizer_tpu`` name replaced by
    ``renormalizer_tpu_torch``."""
    return _JAX_PACKAGE.sub("renormalizer_tpu_torch", source)


def example_paths(names=()):
    """The examples' paths, in name order; ``names`` (with or without
    ``.py``) picks some of them."""
    paths = sorted(os.path.join(EXAMPLES, f) for f in os.listdir(EXAMPLES)
                   if f.endswith(".py"))
    if not names:
        return paths
    wanted = {n if n.endswith(".py") else n + ".py" for n in names}
    picked = [p for p in paths if os.path.basename(p) in wanted]
    unknown = wanted - {os.path.basename(p) for p in picked}
    if unknown:
        raise SystemExit(f"no such example: {', '.join(sorted(unknown))}")
    return picked


def _execute(path, argv=()):
    """Run the rewritten copy of ``path`` as ``__main__`` in this process,
    with ``sys.argv`` set; the root logger is restored afterwards (examples
    call ``logging.basicConfig``).  Returns the module's globals and the
    seconds."""
    with open(path) as f:
        source = rewrite(f.read())
    root = logging.getLogger()
    saved = (sys.argv, root.level, list(root.handlers))
    with tempfile.TemporaryDirectory(prefix="reno_example_") as tmp:
        copy = os.path.join(tmp, os.path.basename(path))
        with open(copy, "w") as f:
            f.write(source)
        sys.argv = [copy, *argv]
        t0 = time.perf_counter()
        try:
            namespace = runpy.run_path(copy, run_name="__main__")
        finally:
            sys.argv = saved[0]
            root.setLevel(saved[1])
            root.handlers[:] = saved[2]
        return namespace, time.perf_counter() - t0


def run_example(path, argv=()):
    """Run the example at ``path`` (rewritten) in this process.  Returns what
    it printed and its seconds; if it raises, what it printed so far goes to
    stderr before the exception propagates."""
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            _, seconds = _execute(path, argv)
    except BaseException:
        sys.stderr.write(out.getvalue())
        raise
    return out.getvalue(), seconds


def _numbers(namespace):
    """The real numbers and real arrays among an example's globals."""
    kept = {}
    for key, value in namespace.items():
        if key.startswith("_") or isinstance(value, bool):
            continue
        if isinstance(value, (int, float)):
            kept[key] = value
        elif isinstance(value, np.ndarray) and value.dtype.kind in "iuf":
            kept[key] = value.tolist()
    return kept


def run_in_subprocess(path, timeout, env=None, dump=None):
    """Run the example at ``path`` through this module in a process of its
    own, from the repository root, killed (with every process it started)
    at ``timeout`` seconds.  ``env`` adds to the environment.  With
    ``dump`` (a file name) the child writes the example's real numbers and
    arrays there as JSON.  Returns a dict: ``status`` ("ok", "timeout" or
    "failed (rc)"), ``seconds``, ``output`` (stdout and stderr) and
    ``numbers`` (the dump, or None)."""
    cmd = [sys.executable, "-m", "renormalizer_tpu_torch.run_examples",
           "--child", path]
    if dump:
        cmd += ["--dump", dump]
    full_env = dict(os.environ, **(env or {}))
    full_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, full_env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, env=full_env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        output, _ = proc.communicate(timeout=timeout)
        status = "ok" if proc.returncode == 0 else f"failed ({proc.returncode})"
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        output, _ = proc.communicate()
        status = "timeout"
    seconds = time.perf_counter() - t0
    numbers = None
    if dump and status == "ok":
        with open(dump) as f:
            numbers = json.load(f)
    return dict(status=status, seconds=seconds, output=output, numbers=numbers)


def _child(path, dump):
    namespace, _ = _execute(path)
    if dump:
        with open(dump, "w") as f:
            json.dump(_numbers(namespace), f)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--timeout", type=float, default=60.0,
                        help="seconds an example may run (run.sh's TIMEOUT)")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    parser.add_argument("--dump", help=argparse.SUPPRESS)
    parser.add_argument("names", nargs="*", help="examples to run (default: all)")
    args = parser.parse_args(argv)
    if args.child:
        _child(args.child, args.dump)
        return 0
    failed = []
    for path in example_paths(args.names):
        name = os.path.basename(path)
        res = run_in_subprocess(path, args.timeout)
        # run.sh's rule: exit 0, or still running at the limit
        passed = res["status"] in ("ok", "timeout")
        print(f"== {name}: {res['status']}, {res['seconds']:.1f} s"
              + ("" if passed else "  FAILED"), flush=True)
        for line in res["output"].rstrip().splitlines()[-TAIL:]:
            print("   " + line[:300])
        if not passed:
            failed.append(name)
    if failed:
        print("failed: " + ", ".join(failed))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
