from visitron_torch.agents.batcher import NavEpisodeBatcher, trim_to_bucket
from visitron_torch.agents.runtime import NavRuntime
from visitron_torch.agents.viewpoint import ViewpointAgent, gather_step_inputs
from visitron_torch.agents.speaker import SpeakerAgent

__all__ = ["NavEpisodeBatcher", "NavRuntime", "SpeakerAgent", "ViewpointAgent",
           "gather_step_inputs", "trim_to_bucket"]
