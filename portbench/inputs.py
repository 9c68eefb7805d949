"""Inputs made from the seed, the same for the program and the reference:
the raw reads of a configuration, and the fields compared of the outputs."""

from __future__ import annotations

import collections
import time

import numpy as np

from portbench import simulate

# the run's start on the clock of time.perf_counter (set by the harness)
START = time.perf_counter()

CAND_FIELDS = ("qid", "sid", "qdir", "score", "qbeg", "qend", "sbeg", "send", "qsize", "ssize")


def read_model(config: dict):
    """(length keywords, ErrorModel) of the configuration's raw reads."""
    r = config["reads"]
    return (dict(mean_len=r["mean_len"], min_len=r["min_len"], max_len=r["max_len"]),
            simulate.ErrorModel(sub=r["sub"], ins=r["ins"], dele=r["dele"]))


def raw_reads(config: dict, seed: int) -> list:
    """The configuration's raw read set: a random genome of genome_size from
    the seed, reads to `coverage` from seed + 1, those shorter than
    min_read_length dropped (MIN_READ_LENGTH); encoded uint8 arrays."""
    lens, em = read_model(config)
    genome = simulate.random_genome(config["genome_size"], seed=seed)
    reads, *_ = simulate.simulate_reads(genome, coverage=config["coverage"], em=em,
                                        seed=seed + 1, **lens)
    return [r for r in reads if len(r) >= config["min_read_length"]]


def records_differ(got: list, want: list) -> int:
    """Correction records that differ between two runs of the same
    templates: each (tid, left) record of either side compared on its right
    end, its corrected flag and its bases; a record on one side only counts
    once."""
    key = lambda r: (int(r.tid), int(r.left))
    a = {key(r): r for r in got}
    b = {key(r): r for r in want}
    n = len(set(a) ^ set(b))
    for k in set(a) & set(b):
        x, y = a[k], b[k]
        if (int(x.right) != int(y.right) or bool(x.corrected) != bool(y.corrected)
                or not np.array_equal(np.asarray(x.seq), np.asarray(y.seq))):
            n += 1
    return n


def _row_keys(rows) -> collections.Counter:
    if isinstance(rows, list):
        return collections.Counter(tuple(int(r[f]) for f in CAND_FIELDS) for r in rows)
    cols = [np.asarray(getattr(rows, f)).astype(np.int64) for f in CAND_FIELDS]
    return collections.Counter(map(tuple, np.stack(cols, 1).tolist()))


def rows_differ(got, want) -> int:
    """Candidate rows that are on one side only, every field compared (rows
    as a Candidates or as a list of dicts)."""
    a, b = _row_keys(got), _row_keys(want)
    return sum(((a - b) + (b - a)).values())


def stamp(label: str) -> str:
    """A line of the set-up's log: seconds since the run's start."""
    return f"setup {label} {time.perf_counter() - START:.3f}\n"
