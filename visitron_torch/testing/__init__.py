from visitron_torch.testing.synthetic import SyntheticWorld

__all__ = ["SyntheticWorld"]
