"""Interleaved A/B of the tier-1 test command between source trees.

Runs the tier-1 command (``pytest tests/ -m 'not slow'`` with 6 xdist
workers, ``--dist loadfile``, a 1470 s limit, ``JAX_PLATFORMS=cpu``) in
each tree of ``--trees`` in the order given (say parent, change, change,
parent, each tree a ``git archive`` unpacked to its own directory), each
run writing a JUnit XML file, then prints for each run its exit code,
wall seconds, the counts of passed / failed / skipped tests, the
worker-seconds of all files and of the port's (``test_torch_*``), and the
worker-seconds of each file named by ``--files``::

    python3 tools/tier1_ab.py --trees A B B A --out DIR [--files test_torch_x ...]
    python3 tools/tier1_ab.py --report DIR [--files ...]   # parse only

A file's worker-seconds is the sum of its test cases' times in the XML.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import time
import xml.etree.ElementTree as ET

COMMAND = ("timeout -k 10 1470 env JAX_PLATFORMS=cpu "
           "ALLOW_MULTIPLE_LIBTPU_LOAD=1 python -m pytest tests/ -q "
           "-m 'not slow' --continue-on-collection-errors -p no:cacheprovider "
           "-p xdist -n 6 --dist loadfile --junitxml={xml} -p no:randomly")


def parse(xml_path):
    """({file: worker-seconds}, {passed / failed / skipped: count})."""
    per, counts = collections.Counter(), collections.Counter()
    for tc in ET.parse(xml_path).getroot().iter("testcase"):
        cls = tc.get("classname", "")
        mod = cls.split(".")[1] if cls.startswith("tests.") else \
            cls.split(".")[0]
        per[mod] += float(tc.get("time", 0))
        res = "passed"
        for child in tc:
            if child.tag in ("failure", "error"):
                res = "failed"
            elif child.tag == "skipped":
                res = "skipped"
        counts[res] += 1
    return per, counts


def report(out, files):
    with open(os.path.join(out, "runs.json")) as f:
        runs = json.load(f)
    for i, run in enumerate(runs, 1):
        per, n = parse(run["xml"])
        port = sum(v for k, v in per.items() if k.startswith("test_torch_"))
        sel = ", ".join(f"{k} {per[k]:.1f}" for k in files if k in per)
        print(f"run {i} {run['tree']}: rc {run['rc']} wall {run['wall']} s "
              f"| passed {n['passed']} failed {n['failed']} skipped "
              f"{n['skipped']} | worker-s all {sum(per.values()):.1f} port "
              f"{port:.1f} | {sel}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="*", default=[])
    ap.add_argument("--out")
    ap.add_argument("--report")
    ap.add_argument("--files", nargs="*", default=[])
    args = ap.parse_args()
    if args.report:
        report(args.report, args.files)
        return
    os.makedirs(args.out, exist_ok=True)
    runs = []
    for i, tree in enumerate(args.trees, 1):
        xml = os.path.abspath(os.path.join(args.out, f"run{i}.xml"))
        log = os.path.join(args.out, f"run{i}.log")
        t0 = time.perf_counter()
        with open(log, "w") as f:
            rc = subprocess.call(COMMAND.format(xml=xml), shell=True,
                                 cwd=tree, stdout=f,
                                 stderr=subprocess.STDOUT)
        runs.append({"tree": tree, "rc": rc, "xml": xml,
                     "wall": round(time.perf_counter() - t0)})
        with open(os.path.join(args.out, "runs.json"), "w") as f:
            json.dump(runs, f)
    report(args.out, args.files)


if __name__ == "__main__":
    main()
