"""Plan2Explore on DreamerV1: the agent, the exploration and finetuning runs and their evaluation."""
