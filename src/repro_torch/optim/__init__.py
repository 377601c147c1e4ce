from repro_torch.optim.adam import (adam, adamw, apply_updates,  # noqa: F401
                                    clip_by_global_norm, global_norm, sgd)
from repro_torch.optim.schedules import (constant, cosine_decay,  # noqa: F401
                                         linear_warmup)
