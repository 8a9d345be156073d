from qaray_tpu_torch.utils.timing import FrameTimer  # noqa: F401
