from vlm_fo1_tpu_torch.upn.wrapper import UPNWrapper  # noqa: F401
