"""Per-env spatial-inertia parameters (the domain-randomization surface).

Each original URDF body contributes a spatial-inertia term that is linear
in its mass scale, so the per-env link inertias are an exact small linear
map of the per-body scale vector, evaluated at reset.
"""
import numpy as np
import torch


def nominal_link_params(model):
    """(nl, 10) nominal spatial inertia per link, float64 numpy."""
    params = np.zeros((model.nl, 10))
    for b in range(model.n_orig):
        params[model.contrib_link[b]] += model.contrib[b]
    return params


def link_params_from_scales(model, scales, dtype=torch.float32,
                            contrib=None):
    """scales: (n_orig, N) per-original-body mass scales -> (nl, 10, N).
    Contributions are added in body order, as in the JAX package.
    ``contrib``: ``model.contrib`` already on the scales' device in
    ``dtype`` (no host-to-device copy, so the call can be captured in a
    CUDA graph)."""
    n = scales.shape[-1]
    if contrib is None:
        contrib = torch.as_tensor(model.contrib, dtype=dtype,
                                  device=scales.device)
    out = torch.zeros((model.nl, 10, n), dtype=dtype, device=scales.device)
    for b in range(model.n_orig):
        li = int(model.contrib_link[b])
        out[li] = out[li] + contrib[b][:, None] * scales[b][None]
    return out


def broadcast_nominal(model, n, dtype=torch.float32, device="cpu"):
    """(nl, 10, N) nominal params broadcast over the batch."""
    p = torch.as_tensor(nominal_link_params(model), dtype=dtype,
                        device=device)
    return p[:, :, None].expand(model.nl, 10, n)
