from hulc_tpu_torch.models.hulc import HulcModel, init_weights_, make_model  # noqa: F401
