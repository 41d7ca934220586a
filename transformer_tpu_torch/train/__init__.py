"""Training, decoding and scoring of the port: loss, schedules, Adam, the
train and eval steps and the epoch loop; token picking, prefill bucketing,
greedy and beam-search translation; BLEU and perplexity."""
