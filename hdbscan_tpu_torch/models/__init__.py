from hdbscan_tpu_torch.models import exact, hdbscan, mr_hdbscan  # noqa: F401
