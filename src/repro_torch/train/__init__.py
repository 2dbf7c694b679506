"""Single-device training: AdamW (optionally with int8 moments) and the
train step."""
