"""One step of the mucociliary model, plainly (upstream main.cu:817-934,
LatticeBoltzmann.cu, ImmersedBoundary.cu), on raw distributions in any
float dtype; the benchmark runs it in float64.

A step at iteration ``it``:

1. collide every cell with the force of the previous step: the
   equilibrium and the Guo term from the half-force-corrected velocity;
   two relaxation times over the pairs (i, opposite i): the even parts
   relax with 1/tau, the odd with 1/tau2, the Guo term split the same way
   (even part (1 - 1/2 tau), odd part (1 - 1/2 tau2)); the rest population
   relaxes with 1/tau and takes no force;
2. stream by pulling f_i from x - c_i, periodic in x; on the floor row the
   up-going populations take the same cell's opposite ones (half-way
   bounce-back), on the top row the down-going take their mirror images
   (specular slip);
3. interpolate at each cilium node on the 3 x 3 cells around it with the
   3-point delta (x periodic): F = sum 2 w (rho u_s - m), from the
   streamed, uncorrected moments;
4. spread F eps w onto the same cells: the force of the next step;
5. add sum_y u_x(x = X - 5, y) / 192 to the flux, u from the streamed f
   with half the new force.
"""

from __future__ import annotations

import torch

from iblb_benchmark.reference.kinematics import Beat

C = ((0, 0), (1, 0), (0, 1), (-1, 0), (0, -1), (1, 1), (-1, 1), (-1, -1),
     (1, -1))
W = (4 / 9, 1 / 9, 1 / 9, 1 / 9, 1 / 9, 1 / 36, 1 / 36, 1 / 36, 1 / 36)
PAIRS = ((1, 3), (2, 4), (5, 7), (6, 8))
OPPOSITE = (0, 3, 4, 1, 2, 7, 8, 5, 6)
MIRROR_Y = (0, 1, 4, 3, 2, 8, 7, 6, 5)
UP, DOWN = (2, 5, 6), (4, 7, 8)
CS = 0.57735          # the kernels' speed of sound (LatticeBoltzmann.cu:11)
CS2 = CS * CS
CS4 = CS2 * CS2
FLUX_DIVISOR = 192.0  # hardcoded in the flux sample (ImmersedBoundary.cu:261)


def delta(r):
    """The 3-point regularised delta with the upstream literals
    (ImmersedBoundary.cu:31-78)."""
    r = r.abs()
    inner = 0.33333 * (1.0 + torch.sqrt(torch.clamp(1.0 - 3.0 * r * r,
                                                    min=0.0)))
    d = 1.0 - r
    outer = 0.16667 * (5.0 - 3.0 * r - torch.sqrt(
        torch.clamp(-3.0 * d * d + 1.0, min=0.0)))
    return torch.where(r <= 0.5, inner,
                       torch.where(r <= 1.5, outer, torch.zeros_like(r)))


class Constants:
    """The lattice's tensors on one device in one dtype, made once."""

    def __init__(self, device, dtype=torch.float64):
        def t(v):
            return torch.tensor(v, dtype=dtype, device=device)[:, None, None]

        self.ii = torch.tensor([i for i, _ in PAIRS], device=device)
        self.jj = torch.tensor([j for _, j in PAIRS], device=device)
        self.cx = t([C[i][0] for i, _ in PAIRS])
        self.cy = t([C[i][1] for i, _ in PAIRS])
        self.w = t([W[i] for i, _ in PAIRS])
        self.sx = torch.tensor([c[0] for c in C], dtype=dtype, device=device)
        self.sy = torch.tensor([c[1] for c in C], dtype=dtype, device=device)


def collide(f, force, tau, tau2, k):
    """f1 [9, Y, X] from f and the previous step's force [2, Y, X], over
    the four pairs (i, j = opposite i) at once: with c = c_i,
    f_i + f_j relaxes with 1/tau to 2 w rho (1 + (c.u)^2 / 2 cs^4
    - u^2 / 2 cs^2) and takes (1 - 1/2 tau) 2 w ((c.u)(c.F) / cs^4
    - u.F / cs^2); f_i - f_j relaxes with 1/tau2 to 2 w rho c.u / cs^2 and
    takes (1 - 1/2 tau2) 2 w c.F / cs^2.  k: Constants."""
    fi, fj = f[k.ii], f[k.jj]
    plus, minus = 0.5 * (fi + fj), 0.5 * (fi - fj)
    rho = f.sum(0)
    ux = ((k.cx * minus).sum(0) * 2.0 + 0.5 * force[0]) / rho
    uy = ((k.cy * minus).sum(0) * 2.0 + 0.5 * force[1]) / rho
    u2 = ux * ux + uy * uy
    uf = ux * force[0] + uy * force[1]
    cu = k.cx * ux + k.cy * uy
    cf = k.cx * force[0] + k.cy * force[1]
    wr = k.w * rho
    a = (plus - wr * (1.0 + cu * cu / (2.0 * CS4) - u2 / (2.0 * CS2))) \
        / tau - (1.0 - 1.0 / (2.0 * tau)) * k.w * (cu * cf / CS4 - uf / CS2)
    b = (minus - wr * cu / CS2) / tau2 \
        - (1.0 - 1.0 / (2.0 * tau2)) * k.w * cf / CS2
    f1 = torch.empty_like(f)
    f1[0] = f[0] - (f[0] - W[0] * rho * (1.0 - u2 / (2.0 * CS2))) / tau
    f1[k.ii] = fi - a - b
    f1[k.jj] = fj - a + b
    return f1


def stream(f1):
    """Pull streaming, periodic in x, bounce-back floor, slip top."""
    out = torch.stack([torch.roll(f1[i], (cy, cx), dims=(0, 1))
                       for i, (cx, cy) in enumerate(C)])
    top = f1.shape[1] - 1
    for i in UP:
        out[i, 0] = f1[OPPOSITE[i], 0]
    for i in DOWN:
        out[i, top] = f1[MIRROR_Y[i], top]
    return out


def stencil(s, xdim, k):
    """(flat cell index [Ns, 9], weight [Ns, 9]) of the 3 x 3 cells around
    each point's nearest cell, x wrapped (every point lies well inside the
    height)."""
    xi = torch.round(s[:, :1]) + k.sx
    yi = torch.round(s[:, 1:]) + k.sy
    w = delta(xi - s[:, :1]) * delta(yi - s[:, 1:])
    idx = yi.to(torch.int64) * xdim + torch.remainder(xi.to(torch.int64),
                                                      xdim)
    return idx, w


def ib_step(f_new, s, u_s, eps, p, k):
    """(force_new [2, Y, X], flux sample) from the streamed f."""
    ydim, xdim = f_new.shape[1:]
    rho = f_new.sum(0).reshape(-1)
    mx = (f_new[1] + f_new[5] + f_new[8] - f_new[3] - f_new[6]
          - f_new[7]).reshape(-1)
    my = (f_new[2] + f_new[5] + f_new[6] - f_new[4] - f_new[7]
          - f_new[8]).reshape(-1)
    idx, w = stencil(s, xdim, k)
    fx = (2.0 * w * (rho[idx] * u_s[:, :1] - mx[idx])).sum(1)
    fy = (2.0 * w * (rho[idx] * u_s[:, 1:] - my[idx])).sum(1)
    share = w * eps[:, None]
    force = torch.zeros((2, ydim * xdim), dtype=f_new.dtype,
                        device=f_new.device)
    force[0].index_put_((idx.reshape(-1),), (share * fx[:, None]).reshape(-1),
                        accumulate=True)
    force[1].index_put_((idx.reshape(-1),), (share * fy[:, None]).reshape(-1),
                        accumulate=True)
    force = force.reshape(2, ydim, xdim)
    col = p.flux_x
    ux = (mx.reshape(ydim, xdim)[:, col] + 0.5 * force[0, :, col]) \
        / rho.reshape(ydim, xdim)[:, col]
    return force, ux.sum() / FLUX_DIVISOR


class Reference:
    """Steps of one configuration (reference.params.Params) on one device;
    ``mask_dtype`` is the precision the overlap test of the cilia runs in
    (the configuration's precision of its points)."""

    def __init__(self, p, device, mask_dtype=torch.float64):
        self.p = p
        self.beat = Beat(p, device)
        self.mask_dtype = mask_dtype
        self.k = Constants(device)

    def run(self, f, force, it, n):
        """n steps from raw f [9, Y, X] and force [2, Y, X] (float64) at
        iteration it: (f, force, the n flux samples)."""
        p = self.p
        its = torch.arange(it, it + n, dtype=torch.int64,
                           device=f.device)
        s, u_s, eps = self.beat.placed(its, self.mask_dtype)
        samples = []
        for step in range(n):
            f = stream(collide(f, force, p.tau, p.tau2, self.k))
            force, q = ib_step(f, s[step], u_s[step], eps[step], p,
                               self.k)
            samples.append(q)
        return f, force, torch.stack(samples)


def velocity(f, force):
    """The half-force-corrected velocity [2, Y, X] of raw f."""
    rho = f.sum(0)
    mx = f[1] + f[5] + f[8] - f[3] - f[6] - f[7]
    my = f[2] + f[5] + f[6] - f[4] - f[7] - f[8]
    return torch.stack([(mx + 0.5 * force[0]) / rho,
                        (my + 0.5 * force[1]) / rho])
