"""The reference's logical sharding rules over named mesh axes
(``rules.py``), which the dry run reads."""
