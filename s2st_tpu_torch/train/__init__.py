"""Stage-5 training: the composite loss, Adam with the inverse-sqrt
schedule, and the one-update trainer."""
