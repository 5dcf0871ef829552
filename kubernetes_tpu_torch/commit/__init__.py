"""The commit plane: the device commit arbiter (`arbiter`) and the fold
planner of the resident-state plane (`fold`)."""
