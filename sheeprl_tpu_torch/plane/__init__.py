"""The policy-publication channel of the actor–learner plane (the rest of
the plane is ROADMAP queue A item 6f)."""
