"""Asset (URDF / actuator-net) path resolution: the repository's own
``resources/`` tree at its root; config paths use the ``{ASSETS}``
placeholder."""
import os

# the repository's resources/, three levels above this file
ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "resources")


def resolve(path):
    """Expand the {ASSETS} placeholder in a config asset path."""
    return path.replace("{ASSETS}", ROOT)
