"""Multitask training: the loss, schedules and the train step."""
