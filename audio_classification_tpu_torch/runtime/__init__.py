"""Host-side runtime helpers: the resource monitor."""
