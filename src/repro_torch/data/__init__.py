"""The synthetic data pipeline the training path reads."""
from repro_torch.data.synthetic import SyntheticPipeline, make_batch  # noqa: F401
