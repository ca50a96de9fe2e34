"""Key-value experiment logger with multiple sinks (PyTorch port's copy
of `kdip_tpu/logger.py`; ref: guided_diffusion/logger.py, the
OpenAI-baselines logger).

`logkv` / `logkv_mean` aggregation, the human-table, JSON, CSV and
TensorBoard output formats, and `log` text messages with levels. The
TensorBoard sink writes through the port's own `tfevents.EventFileWriter`,
which needs no TensorFlow. The formats write what `kdip_tpu`'s write, byte
for byte.
"""

from __future__ import annotations

import datetime
import json
import os
import os.path as osp
import sys
import tempfile
from collections import defaultdict
from contextlib import contextmanager

DEBUG = 10
INFO = 20
WARN = 30
ERROR = 40
DISABLED = 50


class KVWriter:
    def writekvs(self, kvs):
        raise NotImplementedError


class SeqWriter:
    def writeseq(self, seq):
        raise NotImplementedError


class HumanOutputFormat(KVWriter, SeqWriter):
    """Aligned ASCII table (ref: guided_diffusion/logger.py:36-95)."""

    def __init__(self, filename_or_file):
        if isinstance(filename_or_file, str):
            self.file = open(filename_or_file, "wt")
            self.own_file = True
        else:
            assert hasattr(filename_or_file, "read")
            self.file = filename_or_file
            self.own_file = False

    def writekvs(self, kvs):
        key2str = {}
        for key, val in sorted(kvs.items()):
            valstr = f"{val:<8.3g}" if hasattr(val, "__float__") else str(val)
            key2str[self._truncate(key)] = self._truncate(valstr)
        if not key2str:
            print("WARNING: skipping write of an empty key-value dict")
            return
        keywidth = max(map(len, key2str.keys()))
        valwidth = max(map(len, key2str.values()))
        dashes = "-" * (keywidth + valwidth + 7)
        lines = [dashes]
        for key, val in sorted(key2str.items(), key=lambda kv: kv[0].lower()):
            lines.append(f"| {key}{' ' * (keywidth - len(key))} | "
                         f"{val}{' ' * (valwidth - len(val))} |")
        lines.append(dashes)
        self.file.write("\n".join(lines) + "\n")
        self.file.flush()

    @staticmethod
    def _truncate(s, maxlen=30):
        return s[:maxlen - 3] + "..." if len(s) > maxlen else s

    def writeseq(self, seq):
        seq = list(seq)
        for i, elem in enumerate(seq):
            self.file.write(elem)
            if i < len(seq) - 1:
                self.file.write(" ")
        self.file.write("\n")
        self.file.flush()

    def close(self):
        if self.own_file:
            self.file.close()


class JSONOutputFormat(KVWriter):
    """(ref: guided_diffusion/logger.py:98-110)"""

    def __init__(self, filename):
        self.file = open(filename, "wt")

    def writekvs(self, kvs):
        for key, value in sorted(kvs.items()):
            if hasattr(value, "dtype"):
                kvs[key] = float(value)
        self.file.write(json.dumps(kvs) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


class CSVOutputFormat(KVWriter):
    """Schema-evolving CSV (ref: guided_diffusion/logger.py:113-147)."""

    def __init__(self, filename):
        self.file = open(filename, "w+t")
        self.keys = []
        self.sep = ","

    def writekvs(self, kvs):
        extra_keys = list(kvs.keys() - self.keys)
        extra_keys.sort()
        if extra_keys:
            self.keys.extend(extra_keys)
            self.file.seek(0)
            lines = self.file.readlines()
            self.file.seek(0)
            self.file.write(self.sep.join(self.keys) + "\n")
            for line in lines[1:]:
                self.file.write(line[:-1] + self.sep * len(extra_keys) + "\n")
        else:
            self.file.seek(0, 2)
            if self.file.tell() == 0:
                self.file.write(self.sep.join(self.keys) + "\n")
        vals = [kvs.get(k) for k in self.keys]
        self.file.write(self.sep.join(
            "" if v is None else str(v) for v in vals) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


class TensorBoardOutputFormat(KVWriter):
    """Scalar curves viewable in TensorBoard
    (ref: guided_diffusion/logger.py:150-189 — which requires tensorflow;
    here via the dependency-free tfevents writer). The recorded step is the
    kvs' own 'step'/'samples' entry when present, else a running counter."""

    def __init__(self, logdir):
        from .tfevents import EventFileWriter
        self.writer = EventFileWriter(logdir)
        self.step = 0

    def writekvs(self, kvs):
        step = kvs.get("step", kvs.get("samples", self.step))
        scalars = []
        for key, value in sorted(kvs.items()):
            try:
                scalars.append((key, float(value)))
            except (TypeError, ValueError):
                continue
        self.writer.add_scalars(int(step), scalars)
        self.step += 1

    def close(self):
        self.writer.close()


def make_output_format(fmt, ev_dir, log_suffix=""):
    """(ref: guided_diffusion/logger.py:192-208)"""
    os.makedirs(ev_dir, exist_ok=True)
    if fmt == "stdout":
        return HumanOutputFormat(sys.stdout)
    elif fmt == "log":
        return HumanOutputFormat(osp.join(ev_dir, f"log{log_suffix}.txt"))
    elif fmt == "json":
        return JSONOutputFormat(osp.join(ev_dir, f"progress{log_suffix}.json"))
    elif fmt == "csv":
        return CSVOutputFormat(osp.join(ev_dir, f"progress{log_suffix}.csv"))
    elif fmt == "tensorboard":
        return TensorBoardOutputFormat(osp.join(ev_dir, f"tb{log_suffix}"))
    else:
        raise ValueError(f"Unknown format specified: {fmt}")


class Logger:
    """(ref: guided_diffusion/logger.py:332-439)"""

    DEFAULT = None
    CURRENT = None

    def __init__(self, dir, output_formats):
        self.name2val = defaultdict(float)
        self.name2cnt = defaultdict(int)
        self.level = INFO
        self.dir = dir
        self.output_formats = output_formats

    def logkv(self, key, val):
        self.name2val[key] = val

    def logkv_mean(self, key, val):
        oldval, cnt = self.name2val[key], self.name2cnt[key]
        self.name2val[key] = oldval * cnt / (cnt + 1) + val / (cnt + 1)
        self.name2cnt[key] = cnt + 1

    def dumpkvs(self):
        if self.level == DISABLED:
            return
        out = self.name2val.copy()
        for fmt in self.output_formats:
            if isinstance(fmt, KVWriter):
                fmt.writekvs(self.name2val)
        self.name2val.clear()
        self.name2cnt.clear()
        return out

    def log(self, *args, level=INFO):
        if self.level <= level:
            self._do_log(args)

    def set_level(self, level):
        self.level = level

    def get_dir(self):
        return self.dir

    def close(self):
        for fmt in self.output_formats:
            fmt.close()

    def _do_log(self, args):
        for fmt in self.output_formats:
            if isinstance(fmt, SeqWriter):
                fmt.writeseq(map(str, args))


def configure(dir=None, format_strs=None, log_suffix=""):
    """(ref: guided_diffusion/logger.py:442-470)"""
    if dir is None:
        dir = os.getenv("OPENAI_LOGDIR")
    if dir is None:
        dir = osp.join(tempfile.gettempdir(),
                       datetime.datetime.now().strftime("kdip-%Y-%m-%d-%H-%M-%S-%f"))
    assert isinstance(dir, str)
    dir = os.path.expanduser(dir)
    os.makedirs(dir, exist_ok=True)
    if format_strs is None:
        format_strs = os.getenv("OPENAI_LOG_FORMAT", "stdout,log,csv").split(",")
    format_strs = list(filter(None, format_strs))
    output_formats = [make_output_format(f, dir, log_suffix) for f in format_strs]
    Logger.CURRENT = Logger(dir=dir, output_formats=output_formats)
    log(f"Logging to {dir}")
    return Logger.CURRENT


def get_current():
    if Logger.CURRENT is None:
        configure()
    return Logger.CURRENT


def logkv(key, val):
    get_current().logkv(key, val)


def logkv_mean(key, val):
    get_current().logkv_mean(key, val)


def logkvs(d):
    for k, v in d.items():
        logkv(k, v)


def dumpkvs():
    return get_current().dumpkvs()


def log(*args, level=INFO):
    get_current().log(*args, level=level)


def warn(*args):
    log(*args, level=WARN)


@contextmanager
def profile_kv(scopename):
    """Accumulates wall time under 'wait_<scopename>'
    (ref: guided_diffusion/logger.py:241-253)."""
    import time
    logkey = "wait_" + scopename
    tstart = time.time()
    try:
        yield
    finally:
        get_current().name2val[logkey] += time.time() - tstart


def profile(n):
    """Decorator timing a function into 'wait_<n>'
    (ref: guided_diffusion/logger.py:256-268)."""
    def decorator_with_name(func):
        def func_wrapper(*args, **kwargs):
            with profile_kv(n):
                return func(*args, **kwargs)
        return func_wrapper
    return decorator_with_name


@contextmanager
def scoped_configure(dir=None, format_strs=None):
    prev = Logger.CURRENT
    configure(dir=dir, format_strs=format_strs)
    try:
        yield
    finally:
        Logger.CURRENT.close()
        Logger.CURRENT = prev
