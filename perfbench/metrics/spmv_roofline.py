"""spmv_roofline: the decode ticks' SpMV launches' share of their roofline,
in %: their least time (``_work.WorkModel.spmv_bytes`` at the memory
bandwidth) over their device time in the trace, by kernel name."""
from perfbench.metrics._work import bound_seconds

# the ESPIM SpMV bodies of the program's kernels 1-5
KERNELS = ("espim_spmv_stream_kernel", "espim_spmv_stream_glu_kernel",
           "espim_spmv_mv_kernel")


def read(run):
    if run.trace is None or not run.work.sparse or run.peaks is None:
        return None
    kinds = run.trace["kinds"]
    dec = [t for t in run.trace["ticks"] if kinds[t.index] == "decode"]
    spent = sum(op.end_ns - op.start_ns for t in dec for op in t.ops
                if any(k in op.name for k in KERNELS)) / 1e9
    if spent <= 0:
        return None
    bound = sum(bound_seconds(0, run.work.spmv_bytes(
        len(run.ticks[t.index].contexts)), run.peaks) for t in dec)
    return 100.0 * bound / spent
