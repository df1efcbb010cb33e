"""DreamerV3: the actor pieces DreamerV2 shares."""
