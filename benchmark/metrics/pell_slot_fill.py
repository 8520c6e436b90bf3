"""Share (%) of the PELL plane entries that K4 and K5 walk which hold a
stored value: 100 x nnz / walked, summed over the route's PellMatrices
(the program's counter ``ca_lanczos_tpu_torch.ops.pell.SLOT_FILL``:
``nnz``, and ``walked``, each 128-row group's ``slot_count`` slots of
128 lanes).  The rest is padding that the kernels read as zeros, which
their roofline shows only as a gap.  A program without the counter
reads nothing."""


def read(run):
    try:
        from ca_lanczos_tpu_torch.ops.pell import SLOT_FILL
    except ImportError:
        return None
    if not SLOT_FILL.get("walked"):
        return None
    return 100.0 * SLOT_FILL["nnz"] / SLOT_FILL["walked"]
