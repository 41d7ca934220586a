"""Training and decoding of the port: loss, schedules, Adam, the train and
eval steps and the epoch loop; token picking and prefill bucketing."""
