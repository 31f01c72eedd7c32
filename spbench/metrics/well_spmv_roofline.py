"""well_spmv_roofline: kernel C (``well_spmv_kernel``) as a share of
the HBM roofline: the operator's bytes, each nonzero with its int32 column
(``roofline.py``), at 3.35 TB/s over its mean device time a launch (%)."""

from spbench.readers import kernel_roofline


def read(run):
    return kernel_roofline(run, "well_spmv_kernel", indexed=True)
