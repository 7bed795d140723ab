"""The plain reference of the mucociliary model: one straightforward
implementation of what the benchmarked program computes, in plain PyTorch,
importing nothing of the program.

- ``params``: the derived quantities of a configuration file (tau, tau2,
  the beat period, the phase step of each cilium, the flux column).
- ``kinematics``: the cilia's beat in float64 (positions, velocities,
  placement and the overlap mask).
- ``lbm``: one D2Q9 TRT step with Guo forcing in the TRT split, pull
  streaming with a half-way bounce-back floor and a specular top, then the
  immersed-boundary interpolation and spreading on the 3 x 3 stencil of the
  3-point delta, then the flux sample; ``run`` steps it over an interval.
- ``inputs``: the state a run starts from, made from the seed.
"""
