"""Where a pytest run's time goes, file by file: a pytest plugin and its
summary.

As a plugin (``-p instancediff_torch.tools.pytest_timeline``; it writes
one JSON file per process under ``pytest_timeline/`` in the working
directory), each process that runs tests (each xdist worker, or
the one pytest process) records, for every test file in the order it ran
them, its start and end on the wall clock and the CPU seconds the process
(all its threads) and its reaped children spent on it; the controller
records the machine's ``/proc/stat`` CPU counters at the start and the end
of the session (user, system, idle and steal, the share a hypervisor gave
to other machines). Nothing else in the run changes: the plugin only reads
clocks and counters.

As a script, ``python -m instancediff_torch.tools.pytest_timeline [DIR]
[--port-prefix test_torch_]`` prints each worker's files in order with
their start, wall and CPU seconds, the files that ended last, the summed
wall and CPU of the files whose names start with the prefix against all
files, and the machine's CPU shares over the session."""

import argparse
import glob
import json
import os
import resource
import time

import pytest

OUT_DIR = "pytest_timeline"
STAT_FIELDS = ("user", "nice", "system", "idle", "iowait", "irq", "softirq", "steal")


def _cpu_seconds():
    own = resource.getrusage(resource.RUSAGE_SELF)
    kids = resource.getrusage(resource.RUSAGE_CHILDREN)
    return own.ru_utime + own.ru_stime, kids.ru_utime + kids.ru_stime


def _proc_stat():
    """The machine's CPU counters (jiffies) by ``STAT_FIELDS``; {} where
    ``/proc/stat`` is absent."""
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()[1:1 + len(STAT_FIELDS)]
    except OSError:
        return {}
    return dict(zip(STAT_FIELDS, map(int, fields)))


class _Timeline:
    def __init__(self):
        self.files = []
        self.current = None

    def close(self):
        if self.current is not None:
            own, kids = _cpu_seconds()
            c = self.current
            self.files.append({"file": c["file"], "t0": c["t0"], "t1": time.time(),
                               "cpu": own - c["own"], "child_cpu": kids - c["kids"]})
            self.current = None

    def start(self, path):
        self.close()
        own, kids = _cpu_seconds()
        self.current = {"file": path, "t0": time.time(), "own": own, "kids": kids}


_TIMELINE = _Timeline()
_SESSION = {}


def _worker() -> str:
    return os.environ.get("PYTEST_XDIST_WORKER", "main")


def pytest_sessionstart(session):
    if _worker() == "main":
        _SESSION.update(t0=time.time(), stat0=_proc_stat())


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    path = item.nodeid.split("::")[0]
    if _TIMELINE.current is None or _TIMELINE.current["file"] != path:
        _TIMELINE.start(path)
    yield


def pytest_unconfigure(config):
    _TIMELINE.close()
    os.makedirs(OUT_DIR, exist_ok=True)
    record = {"worker": _worker(), "files": _TIMELINE.files}
    if _SESSION:
        record["session"] = dict(_SESSION, t1=time.time(), stat1=_proc_stat())
    with open(os.path.join(OUT_DIR, f"{_worker()}.json"), "w") as f:
        json.dump(record, f)


def load(directory: str):
    """(rows, session): every file a worker ran, with ``worker`` added, and
    the controller's session record ({} if none)."""
    rows, session = [], {}
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            record = json.load(f)
        rows += [dict(r, worker=record["worker"]) for r in record["files"]]
        session = record.get("session") or session
    return rows, session


def cpu_shares(session) -> dict:
    """The machine's CPU shares between the session's two ``/proc/stat``
    readings."""
    a, b = session.get("stat0") or {}, session.get("stat1") or {}
    delta = {k: b[k] - a[k] for k in a if k in b}
    total = sum(delta.values())
    return {k: v / total for k, v in delta.items()} if total else {}


def summary(directory: str, port_prefix: str = "test_torch_") -> str:
    rows, session = load(directory)
    if not rows:
        return f"no timeline under {directory}"
    t0 = session.get("t0", min(r["t0"] for r in rows))
    lines = []
    for worker in sorted({r["worker"] for r in rows}):
        mine = sorted((r for r in rows if r["worker"] == worker), key=lambda r: r["t0"])
        lines.append(f"{worker} ends at {mine[-1]['t1'] - t0:.0f} s: " + " | ".join(
            f"{os.path.basename(r['file'])} @{r['t0'] - t0:.0f} +{r['t1'] - r['t0']:.1f} s "
            f"({r['cpu'] + r['child_cpu']:.1f} CPU-s)" for r in mine))
    last = sorted(rows, key=lambda r: -r["t1"])[:4]
    lines.append("ended last: " + ", ".join(
        f"{os.path.basename(r['file'])} ({r['worker']}, {r['t0'] - t0:.0f} -> "
        f"{r['t1'] - t0:.0f} s)" for r in last))
    port = [r for r in rows if os.path.basename(r["file"]).startswith(port_prefix)]
    for name, group in ((f"{port_prefix}* files", port), ("all files", rows)):
        lines.append(f"{name}: wall {sum(r['t1'] - r['t0'] for r in group):.1f} s, "
                     f"CPU {sum(r['cpu'] + r['child_cpu'] for r in group):.1f} s")
    shares = cpu_shares(session)
    if shares:
        lines.append(f"session {session['t1'] - session['t0']:.0f} s; machine CPU shares: "
                     + ", ".join(f"{k} {v:.3f}" for k, v in shares.items() if v))
    return "\n".join(lines)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("directory", nargs="?", default=OUT_DIR)
    parser.add_argument("--port-prefix", default="test_torch_")
    args = parser.parse_args(argv)
    print(summary(args.directory, args.port_prefix))


if __name__ == "__main__":
    main()
