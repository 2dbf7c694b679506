"""Split-brain serving: engine, page pool, scheduler."""
