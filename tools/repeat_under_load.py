#!/usr/bin/env python3
"""Run one test many times beside the port's spawned-world test files, and
count its failures by their message.

A test that fails only under load (a race between processes) needs the
full suite's load to show: this script starts the suite's form of pytest
(``-p xdist -n 6 --dist loadfile``) over ``--load`` files, and beside it
runs ``--test`` ``--runs`` times, ``--par`` at a time, each run a pytest
process of its own. It prints one JSON line: the runs and passes, each
failed run's first error line, and the load run's exit code, summary line
and seconds a file (setup, call and teardown, from ``--durations=0``).
With ``--runs 0`` it runs the load alone, which times the files.

    python3 tools/repeat_under_load.py [--tree .] [--runs 20] [--par 6]
        [--test NODEID] [--load FILE ...] [--workers 6] [--logs DIR]

``--tree`` runs another checkout (an unpacked parent, say) with its own
``src`` first on the path. CPU only: JAX is kept on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TEST = ("tests/test_torch_mesh_train.py::"
        "test_rank_failure_inside_trainer_fails_the_world")
LOAD = ("tests/test_torch_moe_mesh.py", "tests/test_torch_spmd.py",
        "tests/test_torch_mesh_train.py")
PYTEST = (sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
          "-p", "no:randomly")
ERROR = re.compile(r"^E\s+((?:\w+\.)*\w*(?:Error|Exception)\b.*)$")
DURATION = re.compile(r"^\s*([0-9.]+)s (?:setup|call|teardown)\s+([^:\s]+)::")


def first_error(log: str) -> str:
    """The first ``E   <Name>Error: ...`` line of a pytest log."""
    for line in log.splitlines():
        m = ERROR.match(line)
        if m:
            return m.group(1)
    return log.strip().splitlines()[-1] if log.strip() else ""


def seconds_a_file(log: str) -> dict:
    out = {}
    for line in log.splitlines():
        m = DURATION.match(line)
        if m:
            out[m.group(2)] = round(out.get(m.group(2), 0.0)
                                    + float(m.group(1)), 2)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--par", type=int, default=6)
    ap.add_argument("--test", default=TEST)
    ap.add_argument("--load", nargs="*", default=list(LOAD))
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--logs", default=None,
                    help="keep every run's log here (default: a temporary "
                         "directory, removed)")
    args = ap.parse_args()

    tree = Path(args.tree).resolve()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               ALLOW_MULTIPLE_LIBTPU_LOAD="1",
               PYTHONPATH=os.pathsep.join(
                   [str(tree / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    with tempfile.TemporaryDirectory() as tmp:
        logs = Path(args.logs or tmp)
        logs.mkdir(parents=True, exist_ok=True)
        load = None
        if args.load:
            load_log = open(logs / "load.log", "w")
            load = subprocess.Popen(
                [*PYTEST, "-p", "xdist", "-n", str(args.workers), "--dist",
                 "loadfile", "--durations=0", *args.load],
                cwd=tree, env=env, stdout=load_log,
                stderr=subprocess.STDOUT)

        def run(i: int):
            p = subprocess.run([*PYTEST, args.test], cwd=tree, env=env,
                               capture_output=True, text=True)
            (logs / f"run{i}.log").write_text(p.stdout + p.stderr)
            return p.returncode, first_error(p.stdout)

        try:
            with ThreadPoolExecutor(max(args.par, 1)) as pool:
                runs = list(pool.map(run, range(1, args.runs + 1)))
        finally:
            if load is not None:
                load.wait()
                load_log.close()
        out = dict(tree=str(tree), test=args.test, runs=args.runs,
                   par=args.par,
                   passed=sum(rc == 0 for rc, _ in runs),
                   failures=[dict(run=i, rc=rc, error=err)
                             for i, (rc, err) in enumerate(runs, start=1)
                             if rc != 0])
        if load is not None:
            text = (logs / "load.log").read_text()
            tail = [ln for ln in text.splitlines()
                    if re.search(r"\d+ (passed|failed)", ln)]
            out["load"] = dict(files=args.load, workers=args.workers,
                               rc=load.returncode,
                               summary=tail[-1] if tail else "",
                               seconds_a_file=seconds_a_file(text))
        print(json.dumps(out))


if __name__ == "__main__":
    main()
