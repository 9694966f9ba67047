"""Host geometry helpers."""
