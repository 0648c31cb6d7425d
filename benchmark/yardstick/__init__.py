"""The yardstick: peaks, and operations and bytes counted from shapes."""
