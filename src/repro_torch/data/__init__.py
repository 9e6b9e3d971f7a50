from repro_torch.data.federated import (SCENARIOS, FederatedData,
                                       rotate_images, scenario_concept_shift,
                                       scenario_covariate_shift,
                                       scenario_label_shift)
from repro_torch.data.synthetic import (synthetic_cifar, synthetic_emnist,
                                        synthetic_lm_tokens)

__all__ = ["FederatedData", "rotate_images", "SCENARIOS",
           "scenario_concept_shift", "scenario_covariate_shift",
           "scenario_label_shift", "synthetic_cifar", "synthetic_emnist",
           "synthetic_lm_tokens"]
