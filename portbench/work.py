"""The work of the filter's kernels and of its whole step, counted from
shapes: bytes and operations, and the least time they take at the peaks
of ``peaks.py``.

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again. The counts are frozen here, apart from
the program, so that a change to the program cannot move its own
yardstick.
"""

from __future__ import annotations

from . import peaks


def least_seconds(nbytes: float, flops: float = 0.0,
                  peak: float = peaks.FP32_FLOPS, ops=()) -> float:
    """The larger of the bytes over the HBM rate and the operations over
    their rates (``flops`` at ``peak``; each ``(count, rate)`` of ``ops``
    on its own pipe)."""
    return max([nbytes / peaks.HBM_BYTES_PER_S, flops / peak]
               + [count / rate for count, rate in ops])


def roll_bytes(n: int, d: int, sweeps: int, itemsize: int = 4) -> int:
    """The roll walk: the B uniforms of each particle read (4 B), X read
    and written (2 s d), its weight read and its ancestor written (8)."""
    return (4 * sweeps + 2 * itemsize * d + 8) * n


def cumsum_bytes(n: int) -> int:
    """The cumsum of the weights: w read, the cdf written."""
    return 8 * n


def search_apply_bytes(n: int, d: int, itemsize: int = 4) -> int:
    """The inverse-CDF search and apply: the cdf and the positions read,
    X read and written, the ancestors written."""
    return (12 + 2 * itemsize * d) * n


def chi2_rows(noise: str, df_int) -> int:
    """Random rows the chi-square of one particle takes: none for MVN; for
    an integer df, df // 2 + 2 (df % 2) (one log per pair, a normal for
    the odd one); else three for each of four Marsaglia-Tsang rounds."""
    if noise != "mvt":
        return 0
    if df_int is not None:
        m, odd = divmod(df_int, 2)
        return m + 2 * odd
    return 3 * 4


MAX_INTEGER_DF = 30


def integer_df(df):
    """df as an int when it is a whole number up to ``MAX_INTEGER_DF``
    (drawn as a sum of squared normals, counted by ``chi2_rows``), else
    None (Marsaglia-Tsang)."""
    if df is None or not float(df).is_integer() \
            or not 1 <= df <= MAX_INTEGER_DF:
        return None
    return int(df)


def step_ops(kind: str, d: int, k: int, n: int, *, num_sweeps: int = 10,
             noise: str = "mvt", df_int=5):
    """``(flops, ops)`` of one filter step of n particles, as the fused
    kernels' bound counts them. ``kind`` "step": the Metropolis step with
    ``num_sweeps`` accept uniforms and B + 1 exps; "cdf": the inverse-CDF
    step with one position. Integer multiplies: 40 a Philox call (10
    rounds of two 32 x 32 -> 64 products, both halves), one call a group
    of four of the particle's rows. Special functions: a log, a sqrt and
    a cos a normal, and for MVT the chi-square's log, the sqrt of df / g,
    the two divisions and the log1p (integer df; a Marsaglia-Tsang round
    adds a normal and two logs). Flops: the four products G x, Q z, F x
    and Li r at the unpadded widths, in float32."""
    rows = (num_sweeps if kind == "step" else 1) + 2 * d \
        + chi2_rows(noise, df_int)
    sfu = 3 * d + (num_sweeps + 1 if kind == "step" else 0)
    if noise == "mvt":
        sfu += 4 * 5 + 6 if df_int is None else \
            int(df_int // 2 > 0) + 3 * (df_int % 2) + 4
    ops = ((40.0 * -(-rows // 4) * n, peaks.INT32_MULS),
           (float(sfu) * n, peaks.SFU_OPS))
    flops = 2.0 * (2 * d * d + k * d + k * k) * n
    return flops, ops


def fused_bound(kind: str, d: int, k: int, n: int, *, num_sweeps: int = 10,
                noise: str = "mvt", df_int=5, itemsize: int = 4):
    """``(bytes, flops, peak, ops)`` of one fused step call in the
    "thread" design: X[:, a] read and the new state written, ll and the
    ancestor written, one log weight or cdf entry read (the walk's further
    candidates come from L2)."""
    flops, ops = step_ops(kind, d, k, n, num_sweeps=num_sweeps, noise=noise,
                          df_int=df_int)
    return (2 * itemsize * d + 12) * n, flops, peaks.FP32_FLOPS, ops


def step_kind(resampler: str) -> str:
    return "step" if resampler == "metropolis" else "cdf"


def step_work(cell: dict):
    """``(bytes, flops, peak, ops)`` of one whole filter step of a cell,
    whatever engine runs it: X read and written, the weights and y_t,
    each counted once, and the operations of ``step_ops``. ``cell`` holds
    d, k, noise, df (the configuration) and particles, resampler,
    num_sweeps (the traffic); the engine is not read."""
    d, k, n = cell["d"], cell["k"], cell["particles"]
    flops, ops = step_ops(step_kind(cell["resampler"]), d, k, n,
                          num_sweeps=cell.get("num_sweeps", 10),
                          noise=cell["noise"], df_int=integer_df(cell["df"]))
    return (8 * d + 4) * n + 4 * k, flops, peaks.FP32_FLOPS, ops
