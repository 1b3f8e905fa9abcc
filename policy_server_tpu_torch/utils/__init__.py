"""Host-side utilities (string interning)."""
