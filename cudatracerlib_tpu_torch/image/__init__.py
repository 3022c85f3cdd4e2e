"""Film accumulation."""
