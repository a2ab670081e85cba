from .models import (DimeNetConfig, GCNConfig, GINConfig,  # noqa: F401
                     MeshGraphNetConfig, gnn_forward, gnn_loss, gnn_param_defs)
