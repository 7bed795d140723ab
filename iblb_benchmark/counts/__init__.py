"""What one call of a kernel of the program must move and compute, and
which device operations of a trace make its calls: one module per kernel
(``b4``, ``b5``), each with

    COUNTER      the program's wrapper whose ``.launches`` counts its calls
                 ("module:function")
    counts(p, K, dtype) -> (bytes, operations) of one call, p a
                 reference.params.Params, K the steps one call advances,
                 dtype the storage dtype of f ("float32", ...)
    device_seconds(ops) -> the seconds of the device operations of its
                 calls in a trace window (trace.DeviceOp, sorted by start)

Bytes count each input read once and each output written once; operations
count the arithmetic of the function (per cell and per point below), not
of any one design.  A later kernel gets a module of its own.
"""

from __future__ import annotations

# Arithmetic operations per cell: the collide with and without force, the
# moments (rho, m_x, m_y) of one cell; per IB point: its interpolation and
# spreading over the 3 x 3 stencil.
COLLIDE_FORCED = 163
COLLIDE_FREE = 101
MOMENTS = 19
IB_POINT = 6 * 15 + 9 * (1 + 3 * 2 + 2 * 2) + 8
# points per cilium in the band super-step's point arrays
POINT_BLOCK = 128


def value_bytes(dtype: str) -> tuple[int, int]:
    """(bytes of one f value, bytes of every other value): f is stored in
    ``dtype``; everything else is at least float32."""
    es = {"bfloat16": 2, "float32": 4, "float64": 8}[dtype]
    return es, max(es, 4)


def kernel_name(op_name: str) -> str:
    """The function's own name in a kernel's demangled signature:
    ``void (anonymous namespace)::step_kernel<float, ...>(StepArgs<float>)``
    gives ``step_kernel``."""
    s = op_name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[len("void "):]
    for stop in ("<", "("):
        s = s.split(stop)[0]
    return s.rsplit("::", 1)[-1].strip()


def is_named(op, name: str) -> bool:
    """op is a launch of the kernel function ``name``."""
    return kernel_name(op.name) == name
