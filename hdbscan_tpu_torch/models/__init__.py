from hdbscan_tpu_torch.models import exact, hdbscan  # noqa: F401
