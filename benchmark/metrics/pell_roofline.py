"""K4 and K5 (csrc/pell.cu, ``pell_unit_kernel`` and ``pell_grouped_kernel``,
f32): share of their least time in their device time.

One launch takes one step y = A x - d x - sb v_prev
(``ops.cuda_pell.pell_step``).  Its least work: every stored value of the
matrix read once (nnz x 4 bytes), x read once and y written once (2 n x 4
bytes), and 2 nnz operations, all counted from the benchmark's own
matrix: no index bytes, which each encoding spends in its own way, and no
DIA planes' zeros.  A kernel renamed in the program makes this read
nothing until PATTERNS follows it.
"""

from benchmark.yardstick import roofline

PATTERNS = [r"\bpell_(unit|grouped)_kernel<float\b"]
ITEMSIZE = 4


def read(run):
    return roofline(run, PATTERNS, "float32",
                    lambda m: m.nnz * ITEMSIZE + 2 * m.n * ITEMSIZE,
                    lambda m: 2 * m.nnz)
