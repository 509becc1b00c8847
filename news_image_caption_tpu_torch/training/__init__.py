"""Training: optimizer, train and eval steps, the loop and builders."""
