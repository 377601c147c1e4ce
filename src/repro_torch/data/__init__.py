from repro_torch.data.synthetic import TaskSpec, make_task, DEFAULT_TASKS  # noqa: F401
from repro_torch.data.partition import dirichlet_partition  # noqa: F401
from repro_torch.data.pipeline import ClientDataset  # noqa: F401
