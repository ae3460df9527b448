"""Asset (URDF / actuator-net) path resolution.

The repository ships its own ``resources/`` tree at its root (URDF robot
descriptions + actuator-net weights). Point ``LEGGED_GYM_TPU_ASSETS`` at
another checkout's ``resources`` directory to override it; config paths
use the ``{ASSETS}`` placeholder.
"""
import os

_DEFAULT_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "resources")


def assets_root():
    root = os.environ.get("LEGGED_GYM_TPU_ASSETS")
    if root:
        return root
    if os.path.isdir(_DEFAULT_ROOT):
        return _DEFAULT_ROOT
    raise FileNotFoundError(
        "No asset root found: set LEGGED_GYM_TPU_ASSETS to a legged_gym "
        "'resources' directory (robots/<name>/urdf/*.urdf)")


def resolve(path):
    """Expand the {ASSETS} placeholder in a config asset path."""
    if "{ASSETS}" in path:
        path = path.replace("{ASSETS}", assets_root())
    return path
