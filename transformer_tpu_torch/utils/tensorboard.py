"""Minimal TensorBoard event-file writer (no TensorFlow dependency).

Port of ``transformer_tpu/utils/tensorboard.py`` (a copy, standard library
only). The reference logs loss/accuracy scalars per epoch through
``tf.summary.create_file_writer`` (``train.py:75-76,200-206``). TensorFlow is
not part of this stack, so this module writes the ``tfevents`` wire format
directly: TFRecord framing (length + masked-crc32c) around hand-encoded
``Event``/``Summary`` protobuf messages. Two record kinds cover everything
this repo logs: scalar summaries (three proto fields) and histogram
summaries (``HistogramProto`` — the obs sink exports step-time / latency
distributions from ``obs.quantiles.StreamingHistogram`` bucket state).

Files are readable by stock TensorBoard: ``events.out.tfevents.<ts>.<host>``.
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ----------------------------------------------------------------- crc32c
_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf enc
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _encode_scalar_event(tag_name: str, value: float, step: int, wall_time: float) -> bytes:
    name = tag_name.encode("utf-8")
    summary_value = (
        _tag(1, 2) + _varint(len(name)) + name  # Value.tag
        + _tag(2, 5) + struct.pack("<f", value)  # Value.simple_value
    )
    summary = _tag(1, 2) + _varint(len(summary_value)) + summary_value  # Summary.value
    return (
        _tag(1, 1) + struct.pack("<d", wall_time)  # Event.wall_time
        + _tag(2, 0) + _varint(step)  # Event.step
        + _tag(5, 2) + _varint(len(summary)) + summary  # Event.summary
    )


def _encode_histogram_event(
    tag_name: str,
    step: int,
    wall_time: float,
    *,
    hist_min: float,
    hist_max: float,
    num: float,
    total: float,
    sum_squares: float,
    bucket_limits: list[float],
    bucket_counts: list[float],
) -> bytes:
    """Event carrying one ``Summary.Value.histo`` (HistogramProto: min=1,
    max=2, num=3, sum=4, sum_squares=5, bucket_limit=6 packed, bucket=7
    packed — the shape stock TensorBoard's histogram dashboard reads)."""
    histo = (
        _tag(1, 1) + struct.pack("<d", hist_min)
        + _tag(2, 1) + struct.pack("<d", hist_max)
        + _tag(3, 1) + struct.pack("<d", num)
        + _tag(4, 1) + struct.pack("<d", total)
        + _tag(5, 1) + struct.pack("<d", sum_squares)
    )
    if bucket_limits:
        packed = b"".join(struct.pack("<d", v) for v in bucket_limits)
        histo += _tag(6, 2) + _varint(len(packed)) + packed
        packed = b"".join(struct.pack("<d", v) for v in bucket_counts)
        histo += _tag(7, 2) + _varint(len(packed)) + packed
    name = tag_name.encode("utf-8")
    summary_value = (
        _tag(1, 2) + _varint(len(name)) + name  # Value.tag
        # Value.histo is field 5 in summary.proto (4 is Image — a histogram
        # encoded there renders as nothing in the histogram dashboard).
        + _tag(5, 2) + _varint(len(histo)) + histo
    )
    summary = _tag(1, 2) + _varint(len(summary_value)) + summary_value
    return (
        _tag(1, 1) + struct.pack("<d", wall_time)  # Event.wall_time
        + _tag(2, 0) + _varint(step)  # Event.step
        + _tag(5, 2) + _varint(len(summary)) + summary  # Event.summary
    )


def _encode_file_version(wall_time: float) -> bytes:
    version = b"brain.Event:2"
    return (
        _tag(1, 1) + struct.pack("<d", wall_time)
        + _tag(3, 2) + _varint(len(version)) + version  # Event.file_version
    )


class SummaryWriter:
    """Append-only scalar summary writer producing stock-TensorBoard-readable
    event files."""

    def __init__(self, log_dir: str) -> None:
        os.makedirs(log_dir, exist_ok=True)
        ts = time.time()
        fname = f"events.out.tfevents.{int(ts)}.{socket.gethostname()}"
        self._path = os.path.join(log_dir, fname)
        self._file = open(self._path, "ab")
        self._write_record(_encode_file_version(ts))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc(header)))
        self._file.write(payload)
        self._file.write(struct.pack("<I", _masked_crc(payload)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(
            _encode_scalar_event(tag, float(value), int(step), time.time())
        )

    def histogram(self, tag: str, hist, step: int) -> None:
        """Write one histogram summary from any object with the
        ``obs.quantiles.StreamingHistogram`` export surface (``count``,
        ``total``, ``sum_squares``, ``min``, ``max``, ``buckets()``).
        Duck-typed so this module stays import-free of the obs package.
        Empty distributions are skipped (TensorBoard rejects num=0)."""
        if not hist.count:
            return
        limits = [float(b) for b, _ in hist.buckets()]
        counts = [float(c) for _, c in hist.buckets()]
        self._write_record(
            _encode_histogram_event(
                tag, int(step), time.time(),
                hist_min=float(hist.min), hist_max=float(hist.max),
                num=float(hist.count), total=float(hist.total),
                sum_squares=float(hist.sum_squares),
                bucket_limits=limits, bucket_counts=counts,
            )
        )

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        self._file.close()

    @property
    def path(self) -> str:
        return self._path
