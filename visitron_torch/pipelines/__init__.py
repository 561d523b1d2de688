"""Data pipelines of the port: the pretraining example walk
(pretrain_datagen) and the offline feature pipelines (rendering,
scene_features, region_features, orientation), imported by module."""

from visitron_torch.pipelines.pretrain_datagen import (generate_pretrain_examples,
                                                        walk_path_examples,
                                                        write_pretrain_data)

__all__ = ["walk_path_examples", "generate_pretrain_examples", "write_pretrain_data"]
