"""Plan2Explore on DreamerV2: the agent, the exploration and finetuning runs and their evaluation."""
