"""The commit plane: the device commit arbiter (`arbiter`), the fold
planner of the resident-state plane (`fold`) and the gang commit's
rollback record (`apply`)."""
