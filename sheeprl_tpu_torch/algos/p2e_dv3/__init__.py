"""Plan2Explore on DreamerV3: the agent, the exploration and finetuning runs and their evaluation."""
