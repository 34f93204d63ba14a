"""The port's real-data loaders (mdbn_tpu_torch/data/loaders.py) against the
JAX package's (mdbn_tpu/data/loaders.py), bit for bit.

Each case writes its fixture files (IDX images and labels, gzip or plain;
omics CSVs with and without a header row or a patient-ID column, with
missing values, transposed; clinical CSVs) from a numpy generator with a
fixed seed, calls both loaders with the same arguments and requires the
same arrays (dtype, shape and every bit), the same patient IDs, or, where
the reference raises, the same exception type. Runs on the CPU in a few
seconds.
"""

import gzip
import os
import struct

import numpy as np
import pytest

import mdbn_tpu.data.loaders as J
import mdbn_tpu_torch.data.loaders as T


def _same(a, b):
    """Equal structures of arrays, lists, dicts and scalars, arrays bit for bit."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


def both(name, *args, **kw):
    """Call ``name`` in both packages: the same result, or the same error type."""
    try:
        want = getattr(J, name)(*args, **kw)
    except (ValueError, FileNotFoundError) as e:
        with pytest.raises(type(e)):
            getattr(T, name)(*args, **kw)
        return None
    got = getattr(T, name)(*args, **kw)
    _same(want, got)
    return got


def _idx_images(path, n=12, side=6, seed=0, gz=False, magic=2051):
    imgs = np.random.default_rng(seed).integers(0, 256, (n, side, side)).astype(np.uint8)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(struct.pack(">IIII", magic, n, side, side))
        f.write(imgs.tobytes())
    return path


def _idx_labels(path, n=12, seed=0, gz=False, magic=2049, truncate=0):
    labels = np.random.default_rng(seed).integers(0, 10, n).astype(np.uint8)
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(struct.pack(">II", magic, n))
        f.write(labels[:n - truncate].tobytes())
    return path


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("binarize", ["threshold", "sample", "none", "bogus"])
def test_mnist_images(tmp_path, gz, binarize):
    path = _idx_images(str(tmp_path / ("img.idx.gz" if gz else "img.idx")), gz=gz)
    got = both("load_mnist_images", path, binarize=binarize, threshold=0.4, seed=3)
    if got is not None:
        assert got.shape == (12, 36)


def test_mnist_images_and_labels_errors(tmp_path):
    both("load_mnist_images", str(tmp_path / "absent.idx"))
    both("load_mnist_images", _idx_images(str(tmp_path / "bad.idx"), magic=7))
    both("load_mnist_labels", str(tmp_path / "absent.idx"))
    both("load_mnist_labels", _idx_labels(str(tmp_path / "bad1.idx"), magic=7))
    both("load_mnist_labels", _idx_labels(str(tmp_path / "short.idx"), truncate=2))


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_labels(tmp_path, gz):
    path = _idx_labels(str(tmp_path / ("lab.idx.gz" if gz else "lab.idx")), gz=gz)
    assert both("load_mnist_labels", path).dtype == np.int32


def _write_csv(path, mat, row_ids=None, header=None, missing=()):
    """A CSV of ``mat`` with an optional ID column and header row; the cells
    at the ``missing`` (row, col) positions are written as NA."""
    lines = []
    if header is not None:
        lines.append(",".join(header))
    for i, row in enumerate(mat):
        cells = ["NA" if (i, j) in missing else repr(float(x)) for j, x in enumerate(row)]
        if row_ids is not None:
            cells = [row_ids[i]] + cells
        lines.append(",".join(cells))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _cohort(tmp_path, seed=0, n=9, dims=(5, 4), ids=True, header=True, missing=(),
            shuffle_second=True, drop_from_second=0, transpose_second=False):
    """Two modalities of one cohort: patient IDs P0..P{n-1}, the second file's
    rows in another order (and ``drop_from_second`` patients short), and
    optionally the second file transposed (features as rows)."""
    rng = np.random.default_rng(seed)
    pids = [f"P{i}" for i in range(n)]
    paths = {}
    for m, d in zip(("ge", "meth"), dims):
        mat = rng.standard_normal((n, d)) * 3.0 + 1.0
        order = np.arange(n)
        if m == "meth" and shuffle_second:
            order = rng.permutation(n)[:n - drop_from_second]
        rows = [pids[i] for i in order] if ids else None
        feats = [f"{m}_f{j}" for j in range(d)]
        mis = missing if m == "ge" else ()
        path = str(tmp_path / f"{m}.csv")
        if m == "meth" and transpose_second:
            _write_csv(path, mat[order].T, row_ids=feats,
                       header=(["gene"] + rows) if header else None)
        else:
            _write_csv(path, mat[order], row_ids=rows,
                       header=((["id"] if ids else []) + feats) if header else None,
                       missing=mis)
        paths[m] = path
    return paths, pids


CSV_CASES = {
    "header-ids": dict(),
    "no-header-ids": dict(header=False),
    "header-no-ids": dict(ids=False, shuffle_second=False),
    "no-header-no-ids": dict(ids=False, header=False, shuffle_second=False),
    "missing-error": dict(missing=((2, 1),)),
    "missing-drop": dict(missing=((2, 1), (4, 1))),
    "missing-impute": dict(missing=((2, 1), (5, 3))),
    "intersect-short": dict(drop_from_second=2),
    "transposed": dict(transpose_second=True),
    "no-ids-count-mismatch": dict(ids=False, shuffle_second=True, drop_from_second=1),
}
POLICIES = {"missing-drop": "drop", "missing-impute": "impute_mean"}


@pytest.mark.parametrize("align", ["strict", "intersect"])
@pytest.mark.parametrize("name", list(CSV_CASES))
def test_omics_csv(tmp_path, name, align):
    paths, _ = _cohort(tmp_path, **CSV_CASES[name])
    for zscore in (True, False):
        both("load_omics_csv", paths, zscore_features=zscore,
             nan_policy=POLICIES.get(name, "error"), align=align, return_ids=True)
    both("load_omics_csv", paths, align=align)


@pytest.mark.parametrize("orientation", ["auto", "patients_rows", "features_rows",
                                         {"ge": "patients_rows", "meth": "features_rows"},
                                         {"bogus": "patients_rows"}, "sideways"])
def test_omics_csv_orientation(tmp_path, orientation):
    paths, pids = _cohort(tmp_path, transpose_second=True)
    both("load_omics_csv", paths, return_ids=True, orientation=orientation)
    both("load_omics_csv", paths, return_ids=True, orientation=orientation,
         reference_ids=pids)


@pytest.mark.parametrize("header", ["auto", True, False])
def test_omics_csv_header_override(tmp_path, header):
    """A numeric header row (e.g. years as column names) under each setting."""
    rng = np.random.default_rng(2)
    path = _write_csv(str(tmp_path / "x.csv"), rng.standard_normal((6, 3)),
                      header=["1999", "2000", "2001"])
    both("load_omics_csv", {"x": path}, header=header)


def test_omics_csv_errors(tmp_path):
    paths, _ = _cohort(tmp_path)
    both("load_omics_csv", paths, align="loose")
    both("load_omics_csv", paths, nan_policy="zero")
    both("load_omics_csv", {"ge": str(tmp_path / "absent.csv")})
    dup = _write_csv(str(tmp_path / "dup.csv"), np.ones((3, 2)), row_ids=["A", "A", "B"])
    both("load_omics_csv", {"d": dup})
    empty = str(tmp_path / "empty.csv")
    open(empty, "w").close()
    both("load_omics_csv", {"e": empty})
    all_na = _write_csv(str(tmp_path / "na.csv"), np.ones((3, 2)),
                        missing={(i, j) for i in range(3) for j in range(2)})
    both("load_omics_csv", {"n": all_na}, nan_policy="drop")


def _clinical(path, n=9, seed=0, ids=True, header=("patient", "days", "status"),
              order=None, bad=None):
    rng = np.random.default_rng(seed)
    times = rng.exponential(100.0, n).round(2)
    events = rng.integers(0, 2, n)
    lines = [",".join(header)] if header else []
    for i in (order if order is not None else range(n)):
        cells = ([f"P{i}"] if ids else []) + [repr(float(times[i])), str(int(events[i]))]
        lines.append(",".join(cells))
    if bad is not None:
        lines[-1] = bad
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("case", ["ids-header", "ids-no-header", "two-columns",
                                  "two-columns-header", "event-first-by-name"])
def test_clinical_csv(tmp_path, case):
    kw = {"ids-header": dict(order=np.random.default_rng(1).permutation(9)),
          "ids-no-header": dict(header=None),
          "two-columns": dict(ids=False, header=None),
          "two-columns-header": dict(ids=False, header=("time", "event")),
          "event-first-by-name": dict(header=("patient", "status", "days"))}[case]
    path = _clinical(str(tmp_path / "c.csv"), **kw)
    both("load_clinical_csv", path)
    both("load_clinical_csv", path, patient_ids=[f"P{i}" for i in (3, 0, 8, 1, 2, 4, 5, 6, 7)])
    both("load_clinical_csv", path, patient_ids=["P0", "P99"])


def test_clinical_csv_errors(tmp_path):
    both("load_clinical_csv", str(tmp_path / "absent.csv"))
    for bad in ("P8,-1.0,1", "P8,5.0,2", "P8,x,1", "P8"):
        both("load_clinical_csv", _clinical(str(tmp_path / "c.csv"), bad=bad))
    only_header = str(tmp_path / "h.csv")
    with open(only_header, "w") as f:
        f.write("patient,days,status\n")
    both("load_clinical_csv", only_header)
