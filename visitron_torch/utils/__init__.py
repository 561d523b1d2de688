from visitron_torch.utils.timer import Timer, time_since

__all__ = ["Timer", "time_since"]
