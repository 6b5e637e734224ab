"""The plain reference (pt/), the control's lower precision
(precision.py) and the comparisons that decide `correct` (compare.py)."""
