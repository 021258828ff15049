from mjrl_tpu_torch.models.fc_network import (
    Transforms, identity_transforms, make_transforms, mlp_forward)
from mjrl_tpu_torch.models.policies import (
    GaussianLinear, GaussianMLP, LinearPolicy, MLP, Policy)
