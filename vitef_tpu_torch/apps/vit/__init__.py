"""ViT read-outs: plasticity analysis and linear probing."""
