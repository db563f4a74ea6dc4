from blasr_jax.io.fasta import read_fasta, write_fasta  # noqa: F401
from blasr_jax.io.fastq import read_fastq, write_fastq  # noqa: F401
from blasr_jax.io.seqdb import SeqDB  # noqa: F401
from blasr_jax.io.batching import ReadBatch, Read, batch_reads, read_records  # noqa: F401
