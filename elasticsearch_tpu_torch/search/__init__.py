"""Search layer of the port: the fused planner's device stages."""
