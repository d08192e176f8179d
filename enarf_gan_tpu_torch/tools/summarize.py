"""Medians of probe runs: the JSON lines that several runs of a probe CLI
(``python -m enarf_gan_tpu_torch.tools.<module>``, one process each) wrote,
grouped by probe. For each probe and each µs field (``device_us``,
``host_us``, those of the library call and, with ``--against``, of the
other tree) the median and range over the runs, and in how many runs the
kernel's device µs was below the other tree's and at or below the library
call's. Prints one JSON line a probe.

    python -m enarf_gan_tpu_torch.tools.summarize run_1.jsonl run_2.jsonl ...
"""
from __future__ import annotations

import json
import statistics
import sys

FIELDS = ("device_us", "host_us", "library_device_us", "library_host_us",
          "other_device_us", "other_host_us")


def summarize(lines):
    """{probe: summary} of probe lines (dicts) from several runs; a probe
    timed beside another tree's probe of another name (``other_probe``) is
    summarised apart, under "<probe> | <other_probe>"."""
    by_probe = {}
    for line in lines:
        other = line.get("other_probe")
        key = line["probe"] if other in (None, line["probe"]) \
            else f"{line['probe']} | {other}"
        by_probe.setdefault(key, []).append(line)
    out = {}
    for key, runs in by_probe.items():
        s = {"probe": runs[0]["probe"], "runs": len(runs)}
        if key != s["probe"]:
            s["other_probe"] = runs[0]["other_probe"]
        for f in FIELDS:
            vals = [r[f] for r in runs if r.get(f) is not None]
            if vals:
                s[f] = {"median": statistics.median(vals), "min": min(vals),
                        "max": max(vals)}
        pairs = [r for r in runs if r.get("other_device_us") is not None]
        if pairs:
            s["below_other"] = sum(r["device_us"] < r["other_device_us"]
                                   for r in pairs)
        libs = [r for r in runs if r.get("library_device_us") is not None]
        if libs:
            s["at_or_below_library"] = sum(
                r["device_us"] <= r["library_device_us"] for r in libs)
        out[key] = s
    return out


def main(argv=None):
    lines = []
    for path in (sys.argv[1:] if argv is None else argv):
        with open(path) as f:
            lines += [json.loads(x) for x in f if x.strip()]
    out = summarize(lines)
    for s in out.values():
        print(json.dumps(s))
    return out


if __name__ == "__main__":
    main()
