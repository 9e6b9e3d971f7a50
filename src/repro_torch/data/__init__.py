from repro_torch.data.federated import FederatedData, scenario_label_shift
from repro_torch.data.synthetic import synthetic_emnist

__all__ = ["FederatedData", "scenario_label_shift", "synthetic_emnist"]
