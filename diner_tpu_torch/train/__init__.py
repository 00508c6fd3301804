"""Model construction, the train step and the eval step."""
