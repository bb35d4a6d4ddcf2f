"""Wire-format tests for the xplane decoder (scripts/xplane_tools.py):
a hand-encoded XSpace protobuf (schema:
tensorflow/core/profiler/protobuf/xplane.proto) must decode to the same
planes/events/stats, and per-op device time must aggregate per
(plane, line) under the plane/line filters."""

import importlib.util
import os
import struct
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location(
    "xplane_tools", os.path.join(REPO, "scripts", "xplane_tools.py"))
xpt = importlib.util.module_from_spec(spec)
spec.loader.exec_module(xpt)


def _varint(v):
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _field(num, wt, payload):
    key = _varint((num << 3) | wt)
    if wt == 2:
        return key + _varint(len(payload)) + payload
    if wt == 0:
        return key + _varint(payload)
    return key + payload


def _stat(md_id, double=None, uint=None):
    b = _field(1, 0, md_id)
    if double is not None:
        b += _field(2, 1, struct.pack("<d", double))
    if uint is not None:
        b += _field(3, 0, uint)
    return b


def _event(md_id, offset_ps, dur_ps, stats=()):
    b = _field(1, 0, md_id) + _field(2, 0, offset_ps) + _field(3, 0, dur_ps)
    for s in stats:
        b += _field(4, 2, s)
    return b


def _md_entry(fnum, key, name):
    inner = _field(2, 2, name.encode())
    return _field(fnum, 2, _field(1, 0, key) + _field(2, 2, inner))


def _make_space():
    # plane "/device:GPU:0": one line "XLA Ops", two ops:
    #   fusion.1: 10 us, with a 1.97e9 flops stat
    #   copy.2:   10 us, no stat
    line = _field(2, 2, b"XLA Ops")
    line += _field(4, 2, _event(1, 0, 10_000_000,
                                [_stat(7, double=1.97e9)]))
    line += _field(4, 2, _event(2, 10_000_000, 10_000_000))
    plane = _field(2, 2, b"/device:GPU:0")
    plane += _field(3, 2, line)
    plane += _md_entry(4, 1, "fusion.1")
    plane += _md_entry(4, 2, "copy.2")
    plane += _md_entry(5, 7, "flops")
    return _field(1, 2, plane)


def test_parse_and_aggregate(tmp_path):
    p = tmp_path / "t.xplane.pb"
    p.write_bytes(_make_space())
    planes = xpt.parse_xspace(str(p))
    assert len(planes) == 1
    name, md, lines, smd = planes[0]
    assert name == "/device:GPU:0"
    assert md == {1: "fusion.1", 2: "copy.2"}
    assert smd == {7: "flops"}
    agg = xpt.aggregate(planes)
    ops = agg[("/device:GPU:0", "XLA Ops")]
    assert ops["fusion.1"] == (10_000_000, 1)
    assert ops["copy.2"] == (10_000_000, 1)


@pytest.mark.parametrize("plane, line, hits", [
    ("", "", 1), ("gpu", "", 1), ("", "xla", 1), ("cpu", "", 0),
    ("", "steps", 0),
])
def test_aggregate_filters(tmp_path, plane, line, hits):
    p = tmp_path / "t.xplane.pb"
    p.write_bytes(_make_space())
    planes = xpt.parse_xspace(str(p))
    assert len(xpt.aggregate(planes, plane, line)) == hits


def test_main_prints_per_op_totals(tmp_path, capsys):
    p = tmp_path / "t.xplane.pb"
    p.write_bytes(_make_space())
    assert xpt.main([str(p)]) == 0
    out = capsys.readouterr().out
    assert "total 0.020 ms" in out and "fusion.1" in out
