"""D2Q9 lattice constants (the port's own copy of
cuda_iblb_11_tpu/core/lattice.py).

Velocity set, weights and the wall-reflection permutations follow the
reference's index convention (reference: CUDA_IBLB_11/LatticeBoltzmann.cu:15-27,
328-353):

    index:      0    1    2    3    4    5     6     7     8
    velocity: (0,0)(1,0)(0,1)(-1,0)(0,-1)(1,1)(-1,1)(-1,-1)(1,-1)
    weight:   4/9  1/9  1/9  1/9  1/9  1/36  1/36  1/36  1/36

Two speed-of-sound constants exist in the reference and both are kept:
``CS_KERNEL`` (0.57735) is what the equilibrium / Guo-forcing kernels use
(LatticeBoltzmann.cu:11), while ``CS_PARAM`` (0.577) is what the host driver
uses to derive TAU and the Mach number (main.cu:27,320,408).  ``PI_REF`` is
the truncated pi literal the beat-pattern kernel uses (main.cu:29).
"""

from __future__ import annotations

import numpy as np

Q = 9  # populations per cell

# Lattice velocities c_i, shape [9, 2] as (cx, cy).
C = np.array(
    [
        [0, 0],
        [1, 0], [0, 1], [-1, 0], [0, -1],
        [1, 1], [-1, 1], [-1, -1], [1, -1],
    ],
    dtype=np.int32,
)

CX = C[:, 0].copy()
CY = C[:, 1].copy()

# Quadrature weights t_i.
W = np.array(
    [4.0 / 9.0]
    + [1.0 / 9.0] * 4
    + [1.0 / 36.0] * 4,
    dtype=np.float64,
)

# Speed of sound: kernel value vs host-parameter value (see module docstring).
CS_KERNEL = 0.57735
CS_PARAM = 0.577
PI_REF = 3.14159

RHO_0 = 1.0

# Halfway bounce-back (no-slip): i -> opposite(i).  Matches the "back stream"
# table (LatticeBoltzmann.cu:332-339): 1<->3, 2<->4, 5<->7, 6<->8.
OPPOSITE = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int32)

# Specular reflection (free-slip): mirror cy -> -cy.  Matches the "slip
# stream" table (LatticeBoltzmann.cu:345-352): 2<->4, 5<->8, 6<->7.
MIRROR_Y = np.array([0, 1, 4, 3, 2, 8, 7, 6, 5], dtype=np.int32)

# Mirror cx -> -cx (for no-slip/slip side walls in non-reference models).
MIRROR_X = np.array([0, 3, 2, 1, 4, 6, 5, 8, 7], dtype=np.int32)

# Populations entering the domain from below (cy > 0) / above (cy < 0).
UP_GOING = np.array([2, 5, 6], dtype=np.int32)     # cy = +1
DOWN_GOING = np.array([4, 7, 8], dtype=np.int32)   # cy = -1


def sanity() -> None:
    """Static consistency checks (run by the test-suite)."""
    assert np.all(C[OPPOSITE] == -C)
    mirrored = C.copy()
    mirrored[:, 1] *= -1
    assert np.all(C[MIRROR_Y] == mirrored)
    mirrored = C.copy()
    mirrored[:, 0] *= -1
    assert np.all(C[MIRROR_X] == mirrored)
    assert abs(W.sum() - 1.0) < 1e-15
    # Second moment isotropy: sum_i w_i c_ia c_ib = cs^2 delta_ab with cs^2=1/3.
    m2 = np.einsum("i,ia,ib->ab", W, C.astype(np.float64), C.astype(np.float64))
    assert np.allclose(m2, np.eye(2) / 3.0)
