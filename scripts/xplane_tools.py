#!/usr/bin/env python
"""Minimal XSpace (.xplane.pb) decoder for device-op attribution.

jax.profiler writes .xplane.pb traces, but tensorboard_plugin_profile is
not installed — so this decodes the protobuf wire format directly (schema:
tensorflow/core/profiler/protobuf/xplane.proto) and aggregates per-op
device time (e.g. the kernels' share of a pipeline pass).

Usage:
  python scripts/xplane_tools.py <trace_dir_or_xplane.pb> [--top N]
                                 [--plane SUBSTR] [--line SUBSTR]

Prints, per matching plane/line, total duration and occurrence count per
event (op) name, sorted by total time.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from collections import defaultdict


def _varint(buf: bytes, i: int):
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message's fields."""
    i = 0
    n = len(buf)
    while i < n:
        key, i = _varint(buf, i)
        fnum, wt = key >> 3, key & 7
        if wt == 0:
            val, i = _varint(buf, i)
        elif wt == 1:
            val = buf[i:i + 8]
            i += 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wt == 5:
            val = buf[i:i + 4]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fnum, wt, val


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def parse_event(buf: bytes):
    """XEvent: metadata_id=1, offset_ps=2, duration_ps=3."""
    md_id = dur = 0
    off = None
    for fnum, wt, val in fields(buf):
        if fnum == 1:
            md_id = val
        elif fnum == 2:
            off = val
        elif fnum == 3:
            dur = val
    return md_id, off, dur


def _f64(b: bytes) -> float:
    import struct

    return struct.unpack("<d", b)[0]


def parse_event_stats(buf: bytes):
    """XEvent stats (field 4, repeated XStat). Returns
    {stat_md_id: value} with numeric/str values decoded.

    XStat: metadata_id=1, double_value=2(wt1), uint64_value=3(wt0),
    int64_value=4(wt0), str_value=5(wt2), bytes_value=6, ref_value=7."""
    stats = {}
    for fnum, wt, val in fields(buf):
        if fnum != 4 or wt != 2:
            continue
        sid = None
        sval = None
        for f2, w2, v2 in fields(val):
            if f2 == 1:
                sid = v2
            elif f2 == 2 and w2 == 1:
                sval = _f64(v2)
            elif f2 in (3, 4, 7) and w2 == 0:
                sval = v2
            elif f2 == 5 and w2 == 2:
                sval = v2.decode("utf-8", "replace")
        if sid is not None:
            stats[sid] = sval
    return stats

def parse_line(buf: bytes):
    """XLine: name=2, events=4. Returns (name, [event bytes])."""
    name = ""
    events = []
    for fnum, wt, val in fields(buf):
        if fnum == 2 and wt == 2:
            name = val.decode("utf-8", "replace")
        elif fnum == 4 and wt == 2:
            events.append(val)
    return name, events


def parse_plane(buf: bytes):
    """XPlane: name=2, lines=3, event_metadata map=4, stat_metadata map=5.

    Returns (name, {md_id: op_name}, [(line_name, [event bytes])],
    {stat_md_id: stat_name})."""
    name = ""
    lines = []
    metadata = {}
    stat_metadata = {}
    for fnum, wt, val in fields(buf):
        if fnum == 2 and wt == 2:
            name = val.decode("utf-8", "replace")
        elif fnum == 3 and wt == 2:
            lines.append(parse_line(val))
        elif fnum in (4, 5) and wt == 2:
            # map entry {key=1: int64, value=2: X{Event,Stat}Metadata}
            key = None
            md_name = ""
            for f2, w2, v2 in fields(val):
                if f2 == 1:
                    key = v2
                elif f2 == 2 and w2 == 2:
                    # X*Metadata: id=1, name=2, display_name=3
                    for f3, w3, v3 in fields(v2):
                        if f3 == 2 and w3 == 2:
                            md_name = v3.decode("utf-8", "replace")
            if key is not None:
                (metadata if fnum == 4 else stat_metadata)[key] = md_name
    return name, metadata, lines, stat_metadata


def parse_xspace(path: str):
    """[(plane_name, metadata, lines)] from an xplane.pb file."""
    with open(path, "rb") as f:
        buf = f.read()
    planes = []
    for fnum, wt, val in fields(buf):
        if fnum == 1 and wt == 2:
            planes.append(parse_plane(val))
    return planes


def find_trace(path: str) -> str:
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "**", "*.xplane.pb"),
                            recursive=True))
    if not hits:
        sys.exit(f"no *.xplane.pb under {path}")
    return hits[-1]


def aggregate(planes, plane_filter="", line_filter=""):
    """{(plane, line): {op: (total_ps, count)}}"""
    out = {}
    for pname, metadata, lines, _smd in planes:
        if plane_filter and plane_filter.lower() not in pname.lower():
            continue
        for lname, events in lines:
            if line_filter and line_filter.lower() not in lname.lower():
                continue
            agg = defaultdict(lambda: [0, 0])
            for ebuf in events:
                md_id, _, dur = parse_event(ebuf)
                name = metadata.get(md_id, f"#{md_id}")
                agg[name][0] += dur
                agg[name][1] += 1
            if agg:
                out[(pname, lname)] = {
                    k: (v[0], v[1]) for k, v in agg.items()
                }
    return out


def dump_stats(planes, plane_filter=""):
    """List every stat name seen per (plane, line), with an example value
    — the discovery mode for what the platform's profiler records."""
    for pname, metadata, lines, smd in planes:
        if plane_filter and plane_filter.lower() not in pname.lower():
            continue
        print(f"\n== plane {pname!r}: {len(smd)} stat kinds")
        for lname, events in lines:
            seen = {}
            for ebuf in events:
                for sid, sval in parse_event_stats(ebuf).items():
                    sname = smd.get(sid, f"#{sid}")
                    if sname not in seen:
                        seen[sname] = sval
            if seen:
                print(f"  line {lname!r}:")
                for sname, sval in sorted(seen.items()):
                    sv = str(sval)
                    print(f"    {sname} = {sv[:70]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="trace dir or .xplane.pb file")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--plane", default="", help="plane name filter (substring)")
    ap.add_argument("--line", default="", help="line name filter (substring)")
    ap.add_argument("--stats", action="store_true",
                    help="dump the stat names the trace records per line")
    args = ap.parse_args(argv)

    path = find_trace(args.path)
    print(f"trace: {path}")
    planes = parse_xspace(path)
    print("planes:", ", ".join(f"{p[0]!r}({sum(len(e) for _, e in p[2])} ev)"
                               for p in planes))
    if args.stats:
        dump_stats(planes, args.plane)
        return 0
    agg = aggregate(planes, args.plane, args.line)
    for (pname, lname), ops in agg.items():
        total = sum(t for t, _ in ops.values())
        print(f"\n== plane {pname!r} line {lname!r} — total {total/1e9:.3f} ms")
        rows = sorted(ops.items(), key=lambda kv: -kv[1][0])[:args.top]
        for name, (t, c) in rows:
            print(f"  {t/1e9:10.3f} ms {100.0*t/max(total,1):5.1f}% ×{c:<7d} {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
