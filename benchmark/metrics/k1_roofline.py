"""K1 (csrc/dia_powers.cu, ``dia_powers_fused``, f32): share of its least
time in its device time.

One launch takes s steps of the recurrence from x, with s the traffic's
basis length.  Its least work: the matrix read once (the fewer of its
DIA planes or its CSR arrays), x read once, the s output vectors written
once, and 2 nnz operations a step, all counted from the benchmark's own
matrix.  A kernel renamed in the program makes this read nothing until
PATTERNS follows it.
"""

from benchmark.yardstick import matrix_bytes, roofline

PATTERNS = [r"\bdia_powers_(reg|band|smem)<float\b"]
ITEMSIZE = 4


def read(run):
    s = int(run.traffic["s"])
    return roofline(run, PATTERNS, "float32",
                    lambda m: matrix_bytes(m, ITEMSIZE) + m.n * ITEMSIZE * (1 + s),
                    lambda m: 2 * m.nnz * s)
