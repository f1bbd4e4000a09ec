"""Command-line entry points: gen, train and train_mnist."""
