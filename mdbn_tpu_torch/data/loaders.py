"""Real-data loaders behind the same interface as the synthetic generators.

A copy of ``mdbn_tpu/data/loaders.py`` (numpy only), so the port reads the
same files into the same arrays, bit for bit, without importing the JAX
package; ``zscore`` is the port's own ``data/synthetic.py``'s.

The loaders read local files and raise a clear error otherwise: IDX image
and label files (gzip or plain) and omics / clinical CSVs. The CSV loaders
are defensive: real TCGA-style exports carry header rows, gene or patient
identifier columns and missing values, and the survival endpoint needs
per-patient (time, event) records aligned to the expression matrices, so
silent-misalignment hazards are hard errors.
"""

from __future__ import annotations

import csv
import gzip
import io
import os
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .synthetic import zscore

_MISSING = {"", "na", "nan", "null", "none", "n/a", "-", "?"}


def load_mnist_images(path: str, binarize: str = "threshold", threshold: float = 0.5,
                      seed: int = 0) -> np.ndarray:
    """Load an IDX-format MNIST image file (optionally .gz) and binarize.

    Binarization method is a knob because the reference's choice is unverified
    (SURVEY.md §7 hard-part #5): "threshold" (p > 0.5), "sample"
    (pixel-probability Bernoulli draw), or "none" (raw [0, 1] intensities,
    e.g. for mean-field experiments).
    """
    if binarize not in ("threshold", "sample", "none"):
        raise ValueError(f"binarize must be 'threshold', 'sample', or 'none', "
                         f"got {binarize!r}")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"MNIST file not found: {path}. This sandbox has no network; "
            "use mdbn_tpu_torch.data.synthetic.mnist_like for a local stand-in."
        )
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"not an IDX image file (magic={magic})")
        raw = np.frombuffer(f.read(), np.uint8).reshape(n, rows * cols)
    probs = raw.astype(np.float32) / 255.0
    if binarize == "none":
        return probs
    if binarize == "sample":
        rng = np.random.default_rng(seed)
        return (rng.random(probs.shape) < probs).astype(np.float32)
    return (probs > threshold).astype(np.float32)


def load_mnist_labels(path: str) -> np.ndarray:
    """Load an IDX1-format MNIST label file (magic 2049, optionally .gz).

    The supervised companion of ``load_mnist_images`` — enables real-MNIST
    ``DBN.finetune`` (softmax-head backprop) from the CLI (VERDICT r2 #5b).
    """
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"MNIST label file not found: {path}. This sandbox has no "
            "network; synthetic data kinds carry planted labels instead.")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"not an IDX label file (magic={magic})")
        labels = np.frombuffer(f.read(), np.uint8)
    if len(labels) != n:
        raise ValueError(f"label file truncated: header says {n} labels, "
                         f"found {len(labels)}")
    return labels.astype(np.int32)


def _is_missing(cell: str) -> bool:
    return cell.strip().lower() in _MISSING


def _is_numeric(cell: str) -> bool:
    if _is_missing(cell):
        return True  # a missing value in a numeric column
    try:
        float(cell)
        return True
    except ValueError:
        return False


def _read_csv_rows(path: str) -> List[List[str]]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", newline="") as f:
        text = f.read()
    sample = text[:4096]
    try:
        dialect = csv.Sniffer().sniff(sample, delimiters=",;\t")
        delim = dialect.delimiter
    except csv.Error:
        delim = ","
    rows = [r for r in csv.reader(io.StringIO(text), delimiter=delim)
            if any(c.strip() for c in r)]
    if not rows:
        raise ValueError(f"{path}: empty CSV")
    return rows


_ID_HEADER_NAMES = {"", "id", "ids", "patient", "patient_id", "patientid",
                    "sample", "sample_id", "sampleid", "case", "case_id",
                    "barcode", "name", "gene", "gene_id", "feature",
                    "features", "symbol", "probe", "probe_id"}


def _detect_header(rows: List[List[str]], data_start_col: int,
                   has_ids: bool) -> bool:
    """A header row usually announces itself with non-numeric feature names;
    when they are ALL numeric-looking (e.g. Entrez gene IDs), recognize it by
    a conventional ID-column title instead — otherwise an all-numeric header
    would be silently ingested as a bogus patient row."""
    if any(not _is_numeric(c) for c in rows[0][data_start_col:]):
        return True
    return has_ids and rows[0][0].strip().lower() in _ID_HEADER_NAMES


def _parse_matrix_csv(path: str, header="auto") -> Tuple[
        np.ndarray, Optional[List[str]], Optional[List[str]]]:
    """Parse a (patients x features) CSV with auto-detected header row and
    row-ID column. Returns (matrix-with-NaNs, row_ids or None,
    feature_names or None). ``header``: "auto" | True | False overrides
    detection for files the heuristic cannot disambiguate (an all-numeric
    header row whose ID column has an unconventional title)."""
    rows = _read_csv_rows(path)
    body = rows[1] if len(rows) > 1 else rows[0]
    # ID column: the first cell of a DATA row is non-numeric. Detected on a
    # non-header row so gene/patient labels in a header can't fool it.
    has_ids = not _is_numeric(body[0])
    data_start_col = 1 if has_ids else 0
    has_header = (_detect_header(rows, data_start_col, has_ids)
                  if header == "auto" else bool(header))
    feature_names = (
        [c.strip() for c in rows[0][data_start_col:]] if has_header else None)
    data_rows = rows[1:] if has_header else rows
    if not data_rows:
        raise ValueError(f"{path}: header only, no data rows")
    ids = [r[0].strip() for r in data_rows] if has_ids else None
    width = len(data_rows[0]) - data_start_col
    mat = np.empty((len(data_rows), width), np.float32)
    for i, r in enumerate(data_rows):
        cells = r[data_start_col:]
        if len(cells) != width:
            raise ValueError(f"{path}: row {i} has {len(cells)} values, "
                             f"expected {width}")
        for j, c in enumerate(cells):
            if _is_missing(c):
                mat[i, j] = np.nan
            else:
                try:
                    mat[i, j] = float(c)
                except ValueError:
                    raise ValueError(
                        f"{path}: non-numeric value {c!r} at data row {i}, "
                        f"column {j} (a stray text column? row IDs are only "
                        f"detected in column 0)") from None
    return mat, ids, feature_names


def _apply_nan_policy(mat: np.ndarray, nan_policy: str, name: str) -> np.ndarray:
    n_nan = int(np.isnan(mat).sum())
    if n_nan == 0:
        return mat
    if nan_policy == "error":
        raise ValueError(
            f"modality {name!r} has {n_nan} missing values; pass "
            "nan_policy='impute_mean' (column-mean fill) or 'drop' "
            "(drop any feature column with a missing value)")
    if nan_policy == "drop":
        keep = ~np.isnan(mat).any(axis=0)
        if not keep.any():
            raise ValueError(f"modality {name!r}: every feature column has "
                             "missing values; nothing left after drop")
        return mat[:, keep]
    if nan_policy == "impute_mean":
        col_mean = np.nanmean(mat, axis=0)
        if np.isnan(col_mean).any():
            raise ValueError(f"modality {name!r}: some feature columns are "
                             "entirely missing; drop them first")
        idx = np.where(np.isnan(mat))
        mat = mat.copy()
        mat[idx] = col_mean[idx[1]]
        return mat
    raise ValueError(f"nan_policy must be 'error', 'drop', or 'impute_mean', "
                     f"got {nan_policy!r}")


def _overlap(a: Optional[List[str]], b) -> int:
    if a is None or b is None:
        return 0
    return len(set(a) & set(b))


def _resolve_orientations(parsed: Dict[str, Tuple[np.ndarray,
                                                  Optional[List[str]],
                                                  Optional[List[str]]]],
                          orientation, reference_ids) -> Dict[str, str]:
    """Per-modality 'patients_rows' | 'features_rows' decision.

    Real TCGA flat exports commonly ship features-as-rows (genes x samples)
    — ingesting one as patients x features z-scores the wrong axis (VERDICT
    r3 missing #5). 'auto' detects the patient axis from its LABELS: the
    axis whose labels intersect ``reference_ids`` (e.g. the clinical
    cohort), or — with no reference — the assignment that maximizes the
    cross-modality shared-label count (patients are shared across platforms;
    gene/probe names are not). A file labeled on neither axis stays
    patients_rows (nothing to detect against; documented default)."""
    names = list(parsed)
    if isinstance(orientation, dict):
        unknown = set(orientation) - set(names)
        if unknown:
            raise ValueError(f"orientation given for unknown modalities "
                             f"{sorted(unknown)}")
        modes = {n: orientation.get(n, "auto") for n in names}
    else:
        modes = {n: orientation for n in names}
    for n, m in modes.items():
        if m not in ("auto", "patients_rows", "features_rows"):
            raise ValueError("orientation must be 'auto', 'patients_rows', "
                             f"or 'features_rows', got {m!r} for {n!r}")
    autos = [n for n in names if modes[n] == "auto"]
    if not autos:
        return modes
    labels = {n: {"patients_rows": parsed[n][1],
                  "features_rows": parsed[n][2]} for n in names}
    if reference_ids is not None:
        ref = set(reference_ids)
        for n in autos:
            r = _overlap(labels[n]["patients_rows"], ref)
            c = _overlap(labels[n]["features_rows"], ref)
            if r == c == 0:
                raise ValueError(
                    f"orientation='auto': neither axis of modality {n!r} "
                    "shares labels with the reference cohort — pass "
                    "orientation='patients_rows' or 'features_rows' "
                    "explicitly")
            modes[n] = "patients_rows" if r >= c else "features_rows"
        return modes
    if len(names) == 1:
        modes[autos[0]] = "patients_rows"
        return modes
    # no reference cohort: pick the assignment whose patient-axis labels are
    # most shared across modalities (2^|autos| combos; modality counts are
    # tiny). Ties keep patients_rows.
    best, best_score = None, -1
    combos = [[]]
    for n in autos:
        combos = [c + [o] for c in combos
                  for o in ("patients_rows", "features_rows")]
    for combo in combos:
        assign = dict(modes)
        assign.update(dict(zip(autos, combo)))
        sets = [labels[n][assign[n]] for n in names]
        sets = [set(s) for s in sets if s is not None]
        if len(sets) < 2:
            score = 0
        else:
            common = set.intersection(*sets)
            score = len(common) * len(sets)
        if score > best_score:
            best, best_score = assign, score
    if best_score <= 0:
        # nothing shared under any assignment: unlabeled axes or disjoint
        # cohorts — fall back to the documented default
        for n in autos:
            modes[n] = "patients_rows"
        return modes
    return best


def load_omics_csv(paths: Dict[str, str], zscore_features: bool = True,
                   nan_policy: str = "error", align: str = "strict",
                   return_ids: bool = False, header="auto",
                   orientation="auto",
                   reference_ids: Optional[Sequence[str]] = None):
    """Load {modality: csv_path} matrices (patients x features), z-scoring
    continuous features as the reference does (BASELINE.json config 2).

    Industrial-strength ingestion (VERDICT r2 #6): auto-detects a header row
    and a patient-ID column per file; missing values follow ``nan_policy``
    ('error' | 'drop' | 'impute_mean'); when every modality carries patient
    IDs the rows are ALIGNED by ID — ``align='strict'`` (default) requires
    identical cohorts (any set mismatch raises), ``align='intersect'`` keeps
    the common patients in the first modality's order. ID-less modalities
    must agree on row count with the rest. With ``return_ids=True`` returns
    (matrices, aligned patient-ID list or None).

    ``orientation`` (VERDICT r3 #6): real TCGA flat exports are typically
    features-as-rows (genes x samples). 'auto' (default) detects the patient
    axis per file from its labels — against ``reference_ids`` (e.g. the
    clinical cohort's patient list) when given, else by maximizing the
    cross-modality shared-label count (patients are shared across
    platforms, gene names are not). 'patients_rows' / 'features_rows' (or a
    {modality: mode} dict) override detection; 'features_rows' transposes,
    so patient IDs come from the file's header and feature names from its
    row-ID column. NaN policy and z-scoring always apply in patient-row
    space (features are columns).
    """
    if align not in ("strict", "intersect"):
        raise ValueError(f"align must be 'strict' or 'intersect', got {align!r}")
    parsed: Dict[str, Tuple[np.ndarray, Optional[List[str]],
                            Optional[List[str]]]] = {}
    for name, path in paths.items():
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"omics file not found: {path}. Use "
                "mdbn_tpu_torch.data.synthetic.tcga_like for a local stand-in.")
        parsed[name] = _parse_matrix_csv(path, header=header)
    modes = _resolve_orientations(parsed, orientation, reference_ids)
    mats: Dict[str, np.ndarray] = {}
    ids: Dict[str, Optional[List[str]]] = {}
    for name, (mat, row_ids, col_ids) in parsed.items():
        if modes[name] == "features_rows":
            mat, row_ids = np.ascontiguousarray(mat.T), col_ids
        mats[name] = _apply_nan_policy(mat, nan_policy, name)
        ids[name] = row_ids

    names = list(paths)
    with_ids = [n for n in names if ids[n] is not None]
    aligned_ids: Optional[List[str]] = None
    if with_ids:
        for n in with_ids:
            dup = len(ids[n]) - len(set(ids[n]))
            if dup:
                raise ValueError(f"modality {n!r} has {dup} duplicate "
                                 "patient IDs")
        ref_name = with_ids[0]
        ref = ids[ref_name]
        common = set(ref)
        for n in with_ids[1:]:
            common &= set(ids[n])
        if align == "strict":
            for n in with_ids[1:]:
                if set(ids[n]) != set(ref):
                    missing = sorted(set(ref) ^ set(ids[n]))[:5]
                    raise ValueError(
                        f"patient cohorts differ between {ref_name!r} and "
                        f"{n!r} (e.g. {missing}); use align='intersect' to "
                        "keep the common patients")
            aligned_ids = list(ref)
        else:
            aligned_ids = [p for p in ref if p in common]
            if not aligned_ids:
                raise ValueError("no common patients across modalities")
        for n in with_ids:
            index = {p: i for i, p in enumerate(ids[n])}
            order = np.asarray([index[p] for p in aligned_ids])
            mats[n] = mats[n][order]
        # ID-less modalities ride along positionally — only safe when their
        # row count matches the aligned cohort exactly
        for n in names:
            if ids[n] is None and len(mats[n]) != len(aligned_ids):
                raise ValueError(
                    f"modality {n!r} has no patient-ID column and its "
                    f"{len(mats[n])} rows don't match the {len(aligned_ids)}"
                    "-patient aligned cohort — row order cannot be trusted")
    else:
        counts = {n: len(mats[n]) for n in names}
        if len(set(counts.values())) > 1:
            raise ValueError(f"modalities disagree on patient count and none "
                             f"carry patient IDs: {counts}")

    out = {n: (zscore(m) if zscore_features else m).astype(np.float32)
           for n, m in mats.items()}
    if return_ids:
        return out, aligned_ids
    return out


_TIME_NAMES = {"time", "days", "months", "survival", "os", "os_time",
               "survival_time", "days_to_event", "futime"}
_EVENT_NAMES = {"event", "status", "death", "dead", "vital_status",
                "os_event", "censor", "fustat"}


def load_clinical_csv(path: str, patient_ids: Optional[Sequence[str]] = None
                      ) -> Tuple[np.ndarray, np.ndarray, Optional[List[str]]]:
    """Load per-patient survival records: (times, events, ids or None).

    Accepts ``patient_id,time,event`` (3+ columns, ID first) or ``time,event``
    (2 columns); a header row is auto-detected, and when present the time /
    event columns are located by name (time/days/survival/... and
    event/status/death/...). ``events`` must be 0 (censored) / 1 (observed).

    With ``patient_ids`` the records are reordered to that cohort — the
    survival leg of the Liang et al. pipeline evaluates clusters of the
    *omics* cohort, so the clinical rows must align to it; any patient
    missing a clinical record is a hard error (VERDICT r2 #5a).
    """
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"clinical file not found: {path}. Use "
            "mdbn_tpu_torch.analysis.survival.synthetic_survival for a stand-in.")
    rows = _read_csv_rows(path)
    body = rows[1] if len(rows) > 1 else rows[0]
    has_ids = not _is_numeric(body[0])
    data_start = 1 if has_ids else 0
    has_header = _detect_header(rows, data_start, has_ids)
    t_col, e_col = data_start, data_start + 1
    if has_header:
        header = [c.strip().lower() for c in rows[0]]
        t_named = [i for i, h in enumerate(header) if h in _TIME_NAMES]
        e_named = [i for i, h in enumerate(header) if h in _EVENT_NAMES]
        if t_named:
            t_col = t_named[0]
        if e_named:
            e_col = e_named[0]
    data_rows = rows[1:] if has_header else rows
    if not data_rows:
        raise ValueError(f"{path}: header only, no data rows")
    ncol = max(t_col, e_col) + 1
    ids = [] if has_ids else None
    times, events = [], []
    for i, r in enumerate(data_rows):
        if len(r) < ncol:
            raise ValueError(f"{path}: row {i} has {len(r)} columns, "
                             f"need at least {ncol}")
        if has_ids:
            ids.append(r[0].strip())
        try:
            t = float(r[t_col])
            e = float(r[e_col])
        except ValueError:
            raise ValueError(f"{path}: non-numeric time/event at row {i}: "
                             f"{r[t_col]!r}, {r[e_col]!r}") from None
        if t < 0:
            raise ValueError(f"{path}: negative survival time {t} at row {i}")
        if e not in (0.0, 1.0):
            raise ValueError(f"{path}: event must be 0 (censored) or 1 "
                             f"(observed), got {e} at row {i}")
        times.append(t)
        events.append(int(e))
    times = np.asarray(times, np.float64)
    events = np.asarray(events, np.int32)
    if patient_ids is not None:
        if ids is None:
            if len(times) != len(patient_ids):
                raise ValueError(
                    f"{path} has no patient-ID column and its {len(times)} "
                    f"rows don't match the {len(patient_ids)}-patient cohort")
        else:
            index = {p: i for i, p in enumerate(ids)}
            missing = [p for p in patient_ids if p not in index]
            if missing:
                raise ValueError(
                    f"{path}: no clinical record for cohort patients "
                    f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
            order = np.asarray([index[p] for p in patient_ids])
            times, events = times[order], events[order]
            ids = list(patient_ids)
    return times, events, ids
