"""Minimal hand-rolled protobuf encoder for the Waymo detection-metrics
``Objects`` message (the port's copy of ``tmae_tpu/datasets/waymo_pb.py``;
on the host): ``waymo_open_dataset/protos/metrics.proto`` + ``label.proto``,
the file format that the official ``compute_detection_metrics_main`` C++
binary reads (reference ``pcdet/datasets/waymo_temporal/waymo_utils.py:
25-67``).

The port does not depend on the waymo_open_dataset package, so the wire
format is produced directly (proto3 wire encoding: tag = field_number << 3 |
wire_type; wire 0 = varint, 1 = 64-bit, 2 = length-delimited, 5 = 32-bit).

Schema (public):
  Objects { repeated Object objects = 1; }
  Object  { Label object = 1; float score = 2; bool overlap_with_nlz = 3;
            string context_name = 4; int64 frame_timestamp_micros = 5; }
  Label   { Box box = 1; Type type = 3; string id = 4; }
  Label.Box { double center_x = 1; center_y = 2; center_z = 3;
              width = 4; length = 5; height = 6; heading = 7; }

NOTE on the width/length field numbers: the public waymo-open-dataset
``label.proto`` declares the dimension fields OUT of numeric order::

    // Dimensions of the box. length: dim x. width: dim y. height: dim z.
    optional double length = 5;
    optional double width = 4;
    optional double height = 6;

i.e. length (dx) is field **5** and width (dy) is field **4** even though
length is declared first. ``encode_box`` below writes dy→4 and dx→5
accordingly; assuming sequential numbering from declaration order would
transpose every non-square box.
  Label.Type { UNKNOWN = 0; VEHICLE = 1; PEDESTRIAN = 2; SIGN = 3;
               CYCLIST = 4; }
"""

from __future__ import annotations

import struct

WAYMO_CLASSES = ('unknown', 'Vehicle', 'Pedestrian', 'Sign', 'Cyclist')


def _varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack('<d', float(v))


def _float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack('<f', float(v))


def _int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(int(v))


def _bytes(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _string(field: int, s: str) -> bytes:
    return _bytes(field, s.encode('utf-8'))


def encode_box(cx, cy, cz, length, width, height, heading) -> bytes:
    return (_double(1, cx) + _double(2, cy) + _double(3, cz)
            + _double(4, width) + _double(5, length) + _double(6, height)
            + _double(7, heading))


def encode_label(box: bytes, obj_type: int, obj_id: str = '') -> bytes:
    out = _bytes(1, box) + _int64(3, obj_type)
    if obj_id:
        out += _string(4, obj_id)
    return out


def encode_object(label: bytes, score: float, context_name: str,
                  timestamp_micros: int) -> bytes:
    return (_bytes(1, label) + _float(2, score)
            + _string(4, context_name) + _int64(5, timestamp_micros))


def serialize_objects(records) -> bytes:
    """records: iterable of dicts with keys box7 (x,y,z,dx,dy,dz,heading in
    lidar frame — dx=length, dy=width, dz=height), score, name (WAYMO_CLASSES
    member), context_name, timestamp_micros."""
    out = bytearray()
    for r in records:
        x, y, z, dx, dy, dz, heading = [float(v) for v in r['box7']]
        box = encode_box(x, y, z, dx, dy, dz, heading)
        label = encode_label(box, WAYMO_CLASSES.index(r['name']))
        obj = encode_object(label, r['score'], r['context_name'],
                            r['timestamp_micros'])
        out += _bytes(1, obj)
    return bytes(out)


def write_pd_detection(detections, infos, out_path):
    """Reference ``create_pd_detection`` (waymo_utils.py:25-67): one Objects
    bin over all frames. detections: per-frame dicts {name, score,
    boxes_lidar}; infos: matching frame infos carrying metadata."""
    records = []
    for info, det in zip(infos, detections):
        meta = info.get('metadata', {})
        ctx = meta.get('context_name', info.get('frame_id', ''))
        ts = int(meta.get('timestamp_micros', 0))
        for i in range(len(det['name'])):
            records.append({
                'box7': det['boxes_lidar'][i][:7],
                'score': float(det['score'][i]),
                'name': str(det['name'][i]),
                'context_name': ctx,
                'timestamp_micros': ts,
            })
    payload = serialize_objects(records)
    with open(out_path, 'wb') as f:
        f.write(payload)
    return out_path
