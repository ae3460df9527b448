"""The benchmark's plain reference: a frozen copy of the port's plain
path (legged_gym_tpu_torch as of commit aae7fbc: config, env, model,
physics with the plain chain step, terrain, SEA actuator, PPO), imported under
this package's name so that nothing here loads the port.

Edits against the port's files: imports renamed; ``assets`` looks for
resources/ three levels up and nowhere else; ``physics/chain_kernel.py``
runs the plain chain step for every launch; the env and PPO run on one
device (the split over ranks is gone), and the env follows the chain
physics only (no general-engine path, no applied UniNet: no cell runs
them). A later change to the port does not move this copy.
"""
