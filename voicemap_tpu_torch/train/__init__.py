"""Device store and batch fetch; the train steps come with the training port."""
