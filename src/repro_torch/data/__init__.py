"""Data pipeline: synthetic corpus/length oracle + workload arrival processes."""
from repro_torch.data.synthetic import (DATASETS, MODELS, Corpus, EXAMPLE_PROMPTS,
                                  LLMProfile, make_corpus, prompt_lengths, sample_lengths)
