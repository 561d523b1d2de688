"""Data pipelines of the port: the pretraining example walk (pretrain_datagen)."""

from visitron_torch.pipelines.pretrain_datagen import (generate_pretrain_examples,
                                                        walk_path_examples,
                                                        write_pretrain_data)

__all__ = ["walk_path_examples", "generate_pretrain_examples", "write_pretrain_data"]
