"""Binary file ingestion: files -> columnar Table.

A copy of the JAX package's `io/binary.py` (`zip_iterator`,
`read_binary_files`, `read_csv`) for this package.  Reference: core
io/binary/BinaryFileFormat.scala:112 (Hadoop-FS binary DataSource
producing (path, bytes) rows with sampleRatio push-down) +
BinaryFileReader.scala:20 (parallel read).

This is THE binary reader; io/image.py's readers delegate here.
`read_csv` parses on the port's host library (`native.load_csv_numeric`),
which raises when it does not build instead of going to `np.loadtxt`.
"""
from __future__ import annotations

import glob as _glob
import os
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from ..core.schema import Table

__all__ = ["read_binary_files", "read_csv", "zip_iterator"]


def zip_iterator(path: str, sample_ratio: float = 1.0, seed: int = 0):
    """Yield (name, bytes) for every file entry of a zip archive, each
    name prefixed with the archive path (StreamUtilities.ZipIterator,
    core/env/StreamUtilities.scala:53-78): directories are skipped and
    `sample_ratio` Bernoulli-samples entries before extraction — the
    zipped-image-dataset ingestion path.
    """
    import zipfile

    rng = random.Random(seed)
    with zipfile.ZipFile(path) as zf:
        for info in zf.infolist():
            if info.is_dir() or rng.random() >= sample_ratio:
                continue
            data = zf.read(info)
            if len(data) != info.file_size:
                raise IOError(
                    f"short read from zip entry {info.filename}: "
                    f"{len(data)} of {info.file_size} bytes")
            yield os.path.join(path, info.filename), data


def read_binary_files(pattern: str, recursive: bool = True,
                      sample_ratio: float = 1.0, seed: int = 0,
                      num_threads: int = 8) -> Table:
    """Read every file matching `pattern` into a Table(path, bytes).

    `sample_ratio` subsamples the file list before any IO (the reference's
    sampleRatio push-down); reads are thread-parallel.
    """
    files = sorted(
        f for f in _glob.glob(pattern, recursive=recursive)
        if os.path.isfile(f)
    )
    if sample_ratio < 1.0:
        rng = random.Random(seed)
        files = [f for f in files if rng.random() < sample_ratio]

    def read(f):
        with open(f, "rb") as fh:
            return fh.read()

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        blobs = list(pool.map(read, files))
    data = np.empty(len(files), dtype=object)
    for i, b in enumerate(blobs):
        data[i] = b
    return Table({"path": np.array(files, dtype=object), "bytes": data})


def read_csv(path: str, has_header: bool = True,
             column_names: Optional[Sequence[str]] = None) -> Table:
    """Numeric CSV -> Table of f64 columns via the host library's parser."""
    from .. import native

    mat = native.load_csv_numeric(path, has_header=has_header)
    if column_names is None:
        if has_header:
            with open(path) as f:
                column_names = f.readline().strip().split(",")
        else:
            column_names = [f"c{i}" for i in range(mat.shape[1])]
    if len(column_names) != mat.shape[1]:
        raise ValueError(
            f"{len(column_names)} names for {mat.shape[1]} columns"
        )
    return Table({name: mat[:, i] for i, name in enumerate(column_names)})
