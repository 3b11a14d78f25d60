"""Model registry: the YAML ``model.name`` → a model class.

Counterpart of ``lanczosnet_tpu/models/__init__.py``. Models of the JAX
registry that are not ported yet raise and name their ROADMAP item.
"""

from lanczosnet_torch.models.ada_lanczos_net import AdaLanczosNet
from lanczosnet_torch.models.lanczos_net import LanczosNet

MODEL_REGISTRY = {"LanczosNet": LanczosNet, "AdaLanczosNet": AdaLanczosNet}

_NOT_PORTED = {
    "GCN": "A7",
    "GraphSAGE": "A7",
    "DCNN": "A7",
    "ChebyNet": "A7",
    "GAT": "A7",
    "MPNN": "A7",
    "GPNN": "A7",
}


def build_model(model_cfg: dict):
    """Build a model from the YAML ``model:`` section with ``num_atom``
    and ``num_task`` merged in."""
    name = model_cfg["name"]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP {_NOT_PORTED[name]})"
        )
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name].from_config(model_cfg)
