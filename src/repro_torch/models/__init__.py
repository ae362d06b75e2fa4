from repro_torch.models.model import (Model, build_model,
                                      analytic_param_count)
