"""Model registry: the YAML ``model.name`` → a model class.

Counterpart of ``lanczosnet_tpu/models/__init__.py``, with the same nine
names.
"""

from lanczosnet_torch.models.ada_lanczos_net import AdaLanczosNet
from lanczosnet_torch.models.chebynet import ChebyNet
from lanczosnet_torch.models.dcnn import DCNN
from lanczosnet_torch.models.gat import GAT
from lanczosnet_torch.models.gcn import GCN
from lanczosnet_torch.models.gpnn import GPNN
from lanczosnet_torch.models.graph_sage import GraphSAGE
from lanczosnet_torch.models.lanczos_net import LanczosNet
from lanczosnet_torch.models.mpnn import MPNN

MODEL_REGISTRY = {
    "GCN": GCN,
    "ChebyNet": ChebyNet,
    "DCNN": DCNN,
    "GAT": GAT,
    "GraphSAGE": GraphSAGE,
    "MPNN": MPNN,
    "GPNN": GPNN,
    "LanczosNet": LanczosNet,
    "AdaLanczosNet": AdaLanczosNet,
}


def build_model(model_cfg: dict):
    """Build a model from the YAML ``model:`` section with ``num_atom``
    and ``num_task`` merged in."""
    name = model_cfg["name"]
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name].from_config(model_cfg)
