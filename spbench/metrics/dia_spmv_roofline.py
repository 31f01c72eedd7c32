"""dia_spmv_roofline: kernel A (``dia_spmv_kernel``) as a share of the
HBM roofline: the operator's bytes (``roofline.py``) at 3.35 TB/s over its
mean device time a launch in the trace (%)."""

from spbench.readers import kernel_roofline


def read(run):
    return kernel_roofline(run, "dia_spmv_kernel", indexed=False)
