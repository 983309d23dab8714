"""Launch helpers of the port (`launcher/local.py`)."""
